#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   — torch / CUDA versions, the card's name and power limit;
  2. build    — the four Hopper kernels built from ``src/repro_torch/csrc``
                with nvcc for sm_90a (one nvcc per source, started
                together);
  3. kernels  — K1 and K2 against their plain PyTorch versions on the card:
                {f32, bf16, int8 + scale} tables x {dense, compact remap}
                at the 512 px path's shapes, a ragged small shape, Dh
                16/32/64;
     windowed — K3 against its plain version: the same tables x {dense,
                compact with keep_idx} at the 1024 px path's shape and on a
                ragged small pyramid (Dh 16 and 64, head_pack 1), with
                points up to three range bounds from their reference, so
                that the windows drop corners;
     decode_grad — K2's backward kernel against its closed-form plain
                version: the same tables x {dense, compact} x head_pack
                {1, 4} x L {1, 3} at the 512 px decoder's shape and a
                ragged small one, with points on integer coordinates and
                outside their level; K2's output carries a grad_fn under
                autograd, and the forward-only K1 and K3 refuse it;
  4. serve    — the port's DetrServeEngine on the full-width
                deformable-DETR-DEFA detector at 512 px (random seeded
                weights, float32) with backend="auto": 4 requests, launch
                counters, and the same forward through torch_gather;
     serve_1024 — the same detector at the 1024 px bucket with an int8
                value table and backend="cuda_windowed" (K3 in the
                encoder, K2 in the decoder): 4 requests, launch counters,
                and the same forward through torch_gather and cuda_fused;
     train    — the full-width deformable-DETR-DEFA detector (512 px,
                float32, decoder head) trained for 3 AdamW steps at B = 2
                on one seeded synthetic batch with backend="cuda_decode"
                (K2 forward and backward in the decoder, torch_gather in
                the encoder): launch counters, finite and falling losses,
                live decoder gradients, and the first step's gradients
                against the same step through torch_gather;
  5. times    — each kernel and its plain version on the operands its
                path gave it, their bounds, K1 on K3's operands, one
                serve forward at B = 2 per path and one train step, each
                with its idle share.

Then the kernel summary line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result.
"""
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): HBM3 rate and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# Eq. 4 per channel per live point: 5 add/sub + 3 mul inside the corner
# differences, 3 add/mul to combine them, then p * S + acc.
FLOPS_PER_CHANNEL_POINT = 13
# K2 backward per channel: <v_c, g> (multiply, add) for every valid corner
# of every point, and p w_c g (multiply) plus its atomic add for every
# valid corner of a live point.
FLOPS_PER_CHANNEL_CORNER_DOT = 2
FLOPS_PER_CHANNEL_CORNER_SCATTER = 2
TRAIN_STEPS = 3
IMG = 512
IMG_WINDOWED = 1024              # the bucket the reference serves with K3
MAX_BATCH = 2
N_REQUESTS = 4
SEED = 0
OUTPUTS = ("cls_logits", "boxes")
LIBRARY_NOTE = ("no single PyTorch call computes the compacted Eq. 4 "
                "aggregation (F.grid_sample samples a dense per-level map and "
                "knows neither the pixel->slot remap nor the int8 scale), nor "
                "its vjp over the staged decode table")


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def tolerance(dtype, scale):
    """Kernel vs plain: f32 1e-5; bf16 one bf16 rounding step of the
    output; int8 1e-5 of the code range times the largest scale."""
    import torch
    if dtype == torch.bfloat16:
        return {"rtol": 2 ** -7, "atol": 1e-5}
    if scale is not None:
        return {"rtol": 1e-5, "atol": 1e-5 * 127 * float(scale.max())}
    return {"rtol": 1e-5, "atol": 1e-5}


def check_close(name, got, want, tol):
    import torch
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{name}: kernel {got.dtype} {tuple(got.shape)} vs "
                             f"plain {want.dtype} {tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"{tol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


# --------------------------------------------------------------------------
# phase 1 + 2
# --------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    line = smi.strip().splitlines()[0]
    print(line, flush=True)                    # name, power.limit as given
    name, power = (s.strip() for s in line.split(",", 1))
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=name, power_limit=power, count=torch.cuda.device_count(),
         kind=torch.cuda.get_device_name(0))
    return line


def phase_build():
    from repro_torch.kernels.build import build_dir, build_kernels
    t0 = time.perf_counter()
    info = build_kernels()
    regs = {n: [ln.strip() for ln in i["log"].splitlines()
                if "registers" in ln or "spill" in ln]
            for n, i in info.items()}
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         per_kernel_seconds={n: round(i["seconds"], 3) for n, i in info.items()},
         dir=str(build_dir()), ptxas=regs)


# --------------------------------------------------------------------------
# phase 3: each kernel against its plain version on synthetic operands
# --------------------------------------------------------------------------

def synthetic_points(gen, shape, level_shapes, device):
    """x, y, start, wl, hl, probs of ``shape`` with random levels; the
    coordinates spill past every level edge; some probabilities are 0."""
    import torch
    starts, sizes = [], 0
    for h, w in level_shapes:
        starts.append(sizes)
        sizes += h * w
    lvl = torch.randint(0, len(level_shapes), shape, generator=gen)
    wl = torch.tensor([w for _, w in level_shapes], dtype=torch.int32)[lvl]
    hl = torch.tensor([h for h, _ in level_shapes], dtype=torch.int32)[lvl]
    st = torch.tensor(starts, dtype=torch.int32)[lvl]
    x = torch.rand(shape, generator=gen) * (wl + 3).float() - 1.5
    y = torch.rand(shape, generator=gen) * (hl + 3).float() - 1.5
    p = torch.softmax(torch.randn(shape, generator=gen), -1)
    p = torch.where(torch.rand(shape, generator=gen) < 0.1, 0.0, p)
    return tuple(t.contiguous().to(device) for t in (x, y, st, wl, hl, p)), sizes


def synthetic_table(gen, b, n_rows, h, dh, dtype, compact, n_pix, device):
    import torch
    v = torch.randn((b, n_rows, h, dh), generator=gen)
    scale = remap = None
    if dtype == torch.int8:
        v = torch.randint(-127, 128, (b, n_rows, h, dh), generator=gen)
        scale = (torch.rand((b, 1, h, dh), generator=gen) * 0.02 + 0.002)
    if compact:
        v[:, -1] = 0                                      # zero sentinel row
        remap = torch.randint(0, n_rows - 1, (b, n_pix), generator=gen)
        remap = torch.where(torch.rand((b, n_pix), generator=gen) < 0.4,
                            n_rows - 1, remap).to(torch.int32)
    as_dev = lambda t: None if t is None else t.contiguous().to(device)
    return as_dev(v.to(dtype)), as_dev(remap), as_dev(scale)


def phase_kernel_checks(device, main_levels):
    import torch
    from repro_torch.kernels import msgs_decode, msgs_fused
    from repro_torch.msda.plan import lane_layout
    gen = torch.Generator().manual_seed(SEED)
    small_levels = ((16, 20), (8, 10), (4, 5), (2, 3))
    n_main = sum(h * w for h, w in main_levels)
    cap_main = sum(max(1, int(round(0.6 * h * w))) for h, w in main_levels) + 1
    # (label, levels, B, Nq_raster, Nq_decode, H, K, Dh, compact rows)
    shapes = [("main", main_levels, 2, n_main, 300, 8, 4, 32, cap_main),
              ("ragged_dh16", small_levels, 1, 37, 23, 4, 16, 16, 300),
              ("dh64", small_levels, 2, 50, 30, 2, 4, 64, 300)]
    results = []
    for label, levels, b, nq, nq_dec, h, k, dh, cap in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for compact in (False, True):
                (pts, n_pix) = synthetic_points(gen, (b, nq, h, k), levels, device)
                n_rows = cap if compact else n_pix
                v, remap, scale = synthetic_table(gen, b, n_rows, h, dh, dtype,
                                                  compact, n_pix, device)
                tol = tolerance(dtype, scale)
                case = f"{label}/{str(dtype)[6:]}/{'compact' if compact else 'dense'}"
                e1 = check_close(
                    f"msgs_fused {case}",
                    msgs_fused.msgs_fused(v, *pts, remap=remap, scale=scale),
                    msgs_fused.msgs_fused_plain(v, *pts, remap=remap,
                                                scale=scale), tol)
                layout, g = lane_layout(h, dh)
                staged = msgs_decode.stage_decode_table(
                    v, remap, head_pack=g if layout == "pack" else 1,
                    scale=scale)
                dpts, _ = synthetic_points(gen, (b, 2, nq_dec, h, k), levels,
                                           device)
                want = msgs_decode.msgs_decode_plain(
                    staged.v, *dpts, staged.remap, staged.scale,
                    head_pack=staged.head_pack, dh=dh)
                e2 = check_close(f"msgs_decode_layers {case}",
                                 msgs_decode.msgs_decode_layers(staged, *dpts),
                                 want, tol)
                e3 = check_close(f"msgs_decode {case}",
                                 msgs_decode.msgs_decode(
                                     staged, *(t[:, 0].contiguous() for t in dpts)),
                                 want[:, 0], tol)
                results.append({"case": case, "fused_err": e1,
                                "decode_layers_err": e2, "decode_err": e3})
    emit("kernels", checks=len(results) * 3, results=results,
         tolerance="f32 1e-5; bf16 rtol 2^-7; int8 1e-5*127*max(scale)")


def window_points(gen, b, levels, h, k, ranges, device):
    """x, y, lvl_of_pt, probs (B, N_in, H, K) for raster queries: every
    point on a random level, offset from its query's reference point by
    up to three times the level's range bound, so that some corners leave
    the tile's windows; some probabilities are 0."""
    import torch
    refs = []
    for hh, ww in levels:
        ys, xs = torch.meshgrid((torch.arange(hh) + 0.5) / hh,
                                (torch.arange(ww) + 0.5) / ww, indexing="ij")
        refs.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
    refs = torch.cat(refs)
    shape = (b, refs.shape[0], h, k)
    lvl = torch.randint(0, len(levels), shape, generator=gen)
    wl = torch.tensor([w for _, w in levels], dtype=torch.float32)[lvl]
    hl = torch.tensor([hh for hh, _ in levels], dtype=torch.float32)[lvl]
    bound = torch.tensor(ranges, dtype=torch.float32)[lvl]
    spread = lambda: (torch.rand(shape, generator=gen) * 6 - 3) * bound
    x = refs[:, 0].view(1, -1, 1, 1) * wl - 0.5 + spread()
    y = refs[:, 1].view(1, -1, 1, 1) * hl - 0.5 + spread()
    p = torch.softmax(torch.randn(shape, generator=gen), -1)
    p = torch.where(torch.rand(shape, generator=gen) < 0.1, 0.0, p)
    return [t.contiguous().to(device) for t in (x, y, lvl.to(torch.int32), p)]


def window_table(gen, b, levels, h, dh, dtype, compact, head_pack, device):
    """(v, remap, keep_idx, scale, caps): a dense table, or an FWP-like
    compact one — per level a raster-sorted keep list of the level's
    capacity, 30 % of it routed to the zero sentinel row."""
    import torch
    from repro_torch.core.fwp import level_capacities, level_starts
    starts, n_in = level_starts(levels)
    remap = keep = caps = None
    n_rows = n_in
    if compact:
        caps = tuple(level_capacities(levels, 0.6))
        keep = torch.stack([torch.cat([
            torch.sort(torch.randperm(hh * ww, generator=gen)[:c])[0] + int(s)
            for (hh, ww), c, s in zip(levels, caps, starts)]) for _ in range(b)])
        n_rows = sum(caps) + 1
        alive = torch.rand((b, n_rows - 1), generator=gen) > 0.3
        slots = torch.where(alive, torch.arange(n_rows - 1), n_rows - 1)
        remap = torch.full((b, n_in), n_rows - 1, dtype=torch.int64)
        remap.scatter_(1, keep, slots)
        keep, remap = keep.to(torch.int32), remap.to(torch.int32)
    v = torch.randn((b, n_rows, h, dh), generator=gen)
    scale = None
    if dtype == torch.int8:
        v = torch.randint(-127, 128, (b, n_rows, h, dh), generator=gen)
        scale = torch.rand((b, h // head_pack, head_pack, dh), generator=gen) \
            * 0.02 + 0.002
    if compact:
        v[:, -1] = 0                                      # zero sentinel row
    as_dev = lambda t: None if t is None else t.contiguous().to(device)
    return as_dev(v.to(dtype)), as_dev(remap), as_dev(keep), as_dev(scale), caps


def level_operands(lvl, levels):
    """K1's per-point (start, width, height) int32 for K3's level index."""
    from repro_torch.msda.sampling import level_meta
    starts, ws, hs, _ = level_meta(levels, device=lvl.device)
    li = lvl.long()
    return [t[li].contiguous() for t in (starts, ws, hs)]


def k1_on_k3_operands(args, kw):
    """K1 (no windows) on the operands of one K3 call: the same table,
    remap and scale, with the level index expanded to K1's geometry."""
    from repro_torch.kernels import msgs_fused
    v, x, y, lvl, p = args
    b, _, h, dh = v.shape
    scale = kw.get("scale")
    if scale is not None:
        scale = scale.reshape(b, 1, h, dh).contiguous()
    st, wl, hl = level_operands(lvl, kw["level_shapes"])
    return lambda: msgs_fused.msgs_fused(v, x, y, st, wl, hl, p,
                                         remap=kw.get("remap"), scale=scale)


def gather_on_k3_operands(args, kw):
    """The torch_gather backend on the operands of one K3 call (the same
    table, points, remap and scale)."""
    from types import SimpleNamespace
    from repro_torch.msda.backends import torch_gather
    from repro_torch.msda.sampling import SamplingPoints
    v, x, y, lvl, p = args
    b, _, h, dh = v.shape
    st, wl, hl = level_operands(lvl, kw["level_shapes"])
    scale = kw.get("scale")
    cache = SimpleNamespace(
        scale=None if scale is None else scale.reshape(b, 1, h, dh))
    return torch_gather(None, v, SamplingPoints(x, y, st, wl, hl, lvl,
                                                kw.get("remap")), p,
                        cache=cache)


def phase_windowed_checks(device):
    import torch
    from repro_torch.kernels import msgs_windowed
    from repro_torch.msda.plan import (block_q_for_levels,
                                       level_shapes_for_resolution)
    gen = torch.Generator().manual_seed(SEED + 1)
    ragged = ((13, 17), (7, 9), (4, 5), (2, 3))
    small_ranges = (3.5, 2.5, 1.5, 1.0)
    # (label, levels, B, H, K, Dh, ranges, head_pack)
    shapes = [("main_1024", level_shapes_for_resolution(IMG_WINDOWED), 2, 8,
               4, 32, (16.0, 12.0, 8.0, 4.0), 4),
              ("ragged_dh16", ragged, 1, 4, 16, 16, small_ranges, 1),
              ("ragged_dh64", ragged, 2, 2, 4, 64, small_ranges, 1)]
    results = []
    for label, levels, b, h, k, dh, ranges, hp in shapes:
        tile_q = max(block_q_for_levels(levels, 128))
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for compact in (False, True):
                pts = window_points(gen, b, levels, h, k, ranges, device)
                v, remap, keep, scale, caps = window_table(
                    gen, b, levels, h, dh, dtype, compact, hp, device)
                kw = dict(remap=remap, keep_idx=keep, scale=scale,
                          level_shapes=levels, ranges=ranges, tile_q=tile_q,
                          head_pack=hp, caps=caps)
                case = f"{label}/{str(dtype)[6:]}/{'compact' if compact else 'dense'}"
                got = msgs_windowed.msgs_windowed_msp(v, *pts, **kw)
                err = check_close(f"msgs_windowed {case}", got,
                                  msgs_windowed.msgs_windowed_msp_plain(
                                      v, *pts, **kw), tolerance(dtype, scale))
                # the windows decide: K1 has none and must differ somewhere
                k1 = k1_on_k3_operands((v, *pts), kw)()
                decided = float(((k1.float() - got.float()).abs().amax(-1)
                                 > 1e-3).float().mean())
                if not decided > 0:
                    raise AssertionError(f"msgs_windowed {case}: no corner "
                                         "left its window; the check is void")
                results.append({"case": case, "windowed_err": err,
                                "window_decided_share": decided})
    emit("windowed", checks=len(results), results=results,
         tolerance="f32 1e-5; bf16 rtol 2^-7; int8 1e-5*127*max(scale)")


def on_grid(gen, pts, share=0.2):
    """The points with ``share`` of their x and of their y moved onto an
    integer coordinate (where a corner weight is exactly 0 or 1)."""
    import torch
    x, y, *rest = pts
    snap = lambda t: torch.where(
        torch.rand(t.shape, generator=gen).to(t.device) < share, torch.floor(t),
        t).contiguous()
    return (snap(x), snap(y), *rest)


def grad_tolerance(name, dtype, scale, want):
    """K2 backward vs plain. d_vp and d_scale: the kernel sums them with
    float32 atomics in an order that changes from run to run, so rtol
    1e-5 (2^-7 for a bf16 d_vp, rounded once from float32 on both sides)
    and atol 1e-5 of the largest entry. The point gradients: each a sum
    over one point's corners in the same order on both sides: float32
    1e-5, int8 1e-5 * 127 * max scale."""
    import torch
    if name in ("d_vp", "d_scale"):
        return {"rtol": 2 ** -7 if dtype == torch.bfloat16 else 1e-5,
                "atol": 1e-5 * max(float(want.abs().max()), 1e-30)}
    return tolerance(torch.float32, scale)


GRAD_NAMES = ("d_vp", "d_x", "d_y", "d_probs", "d_scale")


def check_backward(case, got, want, dtype, scale):
    errs = {}
    for name, a, w in zip(GRAD_NAMES, got, want):
        if (a is None) != (w is None):
            raise AssertionError(f"msgs_decode_backward {case}: {name} is "
                                 f"{a is None} on the card, {w is None} plain")
        if w is not None:
            errs[name] = check_close(f"msgs_decode_backward {case} {name}", a,
                                     w, grad_tolerance(name, dtype, scale, w))
    return errs


def phase_decode_grad(device, main_levels):
    """K2's backward kernel against msgs_decode_backward_plain, and the
    autograd contract of the three kernels on the card."""
    import torch
    from repro_torch.kernels import msgs_decode, msgs_fused, msgs_windowed
    gen = torch.Generator().manual_seed(SEED + 2)
    small_levels = ((13, 17), (7, 9), (4, 5), (2, 3))
    cap_main = sum(max(1, int(round(0.6 * h * w))) for h, w in main_levels) + 1
    # (label, levels, B, Nq, H, K, Dh, compact rows)
    shapes = [("main", main_levels, 2, 300, 8, 4, 32, cap_main),
              ("ragged_dh16", small_levels, 1, 23, 4, 16, 16, 200)]
    results = []
    for label, levels, b, nq, h, k, dh, cap in shapes:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for compact in (False, True):
                for g in (1, 4):
                    for n_layers in (1, 3):
                        pts, n_pix = synthetic_points(gen, (b, n_layers, nq, h, k),
                                                      levels, device)
                        pts = on_grid(gen, pts)
                        n_rows = cap if compact else n_pix
                        v, remap, scale = synthetic_table(
                            gen, b, n_rows, h, dh, dtype, compact, n_pix, device)
                        staged = msgs_decode.stage_decode_table(
                            v, remap, head_pack=g, scale=scale)
                        g_out = torch.randn((b, n_layers, nq, h, dh),
                                            generator=gen).to(device)
                        case = (f"{label}/{str(dtype)[6:]}/"
                                f"{'compact' if compact else 'dense'}/G{g}/L{n_layers}")
                        got = msgs_decode.msgs_decode_backward(staged, *pts, g_out)
                        want = msgs_decode.msgs_decode_backward_plain(
                            staged.v, *pts, g_out, staged.remap, staged.scale,
                            head_pack=g, dh=dh)
                        results.append({"case": case, **check_backward(
                            case, got, want, dtype, staged.scale)})

    # fault 1: K2 under autograd keeps its gradient path
    v, remap, _ = synthetic_table(gen, 2, 300, 8, 32, torch.float32, True,
                                  1000, device)
    pts, _ = synthetic_points(gen, (2, 30, 8, 4), ((20, 25), (10, 10), (5, 5),
                                                   (3, 5)), device)
    v.requires_grad_()
    with torch.enable_grad():
        out = msgs_decode.msgs_decode(
            msgs_decode.stage_decode_table(v, remap, head_pack=4), *pts)
        node = out.grad_fn.next_functions[0][0] if out.grad_fn else None
        if "MsgsDecode" not in type(node).__name__:
            raise AssertionError(f"msgs_decode output's grad_fn {out.grad_fn} "
                                 "does not lead to MsgsDecode")
        before = msgs_decode.LAUNCHES_BWD
        out.square().sum().backward()
        torch.cuda.synchronize()
        if msgs_decode.LAUNCHES_BWD != before + 1 or not v.grad.abs().sum() > 0:
            raise AssertionError("msgs_decode backward did not launch its "
                                 "kernel or gave no table gradient")
        # fault 2: the forward-only kernels refuse autograd
        refused = []
        for name, call in (
                ("msgs_fused", lambda: msgs_fused.msgs_fused(v, *pts, remap=remap)),
                ("msgs_windowed", lambda: msgs_windowed.msgs_windowed_msp(
                    v, pts[0], pts[1], torch.zeros_like(pts[2]), pts[5],
                    level_shapes=((20, 50),), ranges=(2.0,), tile_q=8))):
            try:
                call()
            except RuntimeError as e:
                if "torch_gather" in str(e):
                    refused.append(name)
                    continue
                raise
            raise AssertionError(f"{name} ran under autograd")
    emit("decode_grad", checks=len(results), results=results,
         grad_fn=type(node).__name__, refused_under_autograd=refused,
         tolerance="d_vp, d_scale: rtol 1e-5 (bf16 2^-7), atol 1e-5*max; "
                   "d_x, d_y, d_probs: f32 1e-5, int8 1e-5*127*max(scale)")


# --------------------------------------------------------------------------
# phase 4: serve the full-width detector
# --------------------------------------------------------------------------

def slice_config(name, img=None, table_dtype=None):
    import dataclasses
    import torch
    from repro_torch.configs.detr_family import CONFIGS, with_dtype
    from repro_torch.core.detector import DetectorConfig
    from repro_torch.msda.decoder import MSDADecoderConfig
    enc = with_dtype(CONFIGS[name].encoder, torch.float32)
    if table_dtype is not None:
        enc = dataclasses.replace(enc, attn=dataclasses.replace(
            enc.attn, table_dtype=table_dtype))
    return DetectorConfig(encoder=enc, img_size=img or IMG, n_classes=4,
                          backbone_width=32, decoder=MSDADecoderConfig())


class Recorder:
    """Keeps the operands of the first ``keep`` calls of one kernel
    wrapper during the served run (for the timing phase); installed on
    the wrapper's module and removed again afterwards."""

    def __init__(self, module, attr, keep):
        self.module, self.attr, self.keep = module, attr, keep
        self.orig = getattr(module, attr)
        self.calls = []

    def __call__(self, *args, **kwargs):
        if len(self.calls) < self.keep:
            self.calls.append((args, kwargs))
        return self.orig(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.attr, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.attr, self.orig)


def seeded_images(n, img=None):
    import numpy as np
    rng = np.random.default_rng(SEED)
    img = img or IMG
    return [rng.uniform(0.0, 1.0, (3, img, img)).astype(np.float32)
            for _ in range(n)]


def check_requests(reqs):
    import numpy as np
    for r in reqs:
        if not (r.done and r.cls_probs.shape == (300, 5)
                and r.boxes.shape == (300, 4)
                and np.isfinite(r.cls_probs).all() and np.isfinite(r.boxes).all()):
            raise AssertionError(f"request {r.rid}: done={r.done} "
                                 f"cls {getattr(r.cls_probs, 'shape', None)} "
                                 f"boxes {getattr(r.boxes, 'shape', None)}")


def serve_requests(engine, images):
    """Submit one request per image, drain, synchronize; wall seconds."""
    import torch
    from repro_torch.serve import DetrRequest
    t0 = time.perf_counter()
    reqs = [DetrRequest(rid=i, image=im) for i, im in enumerate(images)]
    for r in reqs:
        if not engine.submit(r):
            raise AssertionError(f"request {r.rid} rejected: {r.error}")
    engine.run_until_drained()
    torch.cuda.synchronize()
    return reqs, time.perf_counter() - t0


def abs_errors(a, g):
    """Median and max of |a - g| for the detector's logits and boxes."""
    out = {}
    for i, name in enumerate(OUTPUTS):
        err = (a[i] - g[i]).abs()
        out[name] = {"max": float(err.max()), "median": float(err.median())}
    return out


def defa_agreement(label, a, g, compare, median=None):
    """DEFA: INT12 fake-quant, PAP top-k and FWP compaction are discrete;
    a float-ulp difference between two samplers can flip a rounding or a
    pick, which moves that query's points. Most outputs must agree and
    none may run away: median 1e-3 (or ``median[output]``), max 0.5
    (logits are O(1), boxes lie in [0, 1])."""
    import torch
    errs = abs_errors(a, g)
    for i, name in enumerate(OUTPUTS):
        compare[f"{label}/{name}"] = errs[name]
        bound = 1e-3 if median is None else median[name]
        if not (torch.isfinite(a[i]).all() and errs[name]["median"] <= bound
                and errs[name]["max"] <= 0.5):
            raise AssertionError(f"{label} {name}: {compare}")


def phase_serve(device):
    import numpy as np
    import torch
    from repro_torch.core.detector import detector_apply, init_detector
    from repro_torch.kernels import msgs_decode, msgs_fused
    from repro_torch.serve import DetrServeEngine

    cfg = slice_config("deformable-detr-defa")
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    images = seeded_images(N_REQUESTS)
    with DetrServeEngine(cfg, params, max_batch=MAX_BATCH, backend="auto",
                         device=device) as engine:
        plan = engine.buckets[0].plan
        with Recorder(msgs_fused, "msgs_fused", 6) as rec_f, \
                Recorder(msgs_decode, "msgs_decode", 6) as rec_d:
            msgs_fused.LAUNCHES = 0
            msgs_decode.LAUNCHES = 0
            reqs, wall = serve_requests(engine, images)
            launches = {"msgs_fused": msgs_fused.LAUNCHES,
                        "msgs_decode": msgs_decode.LAUNCHES}
        batches = engine.batches_dispatched
    check_requests(reqs)
    n_blocks = cfg.encoder.n_blocks
    n_layers = cfg.decoder.n_layers
    if batches != N_REQUESTS // MAX_BATCH \
            or launches["msgs_fused"] != n_blocks * batches \
            or launches["msgs_decode"] != n_layers * batches:
        raise AssertionError(f"launch counts {launches} over {batches} batches; "
                             f"expected {n_blocks} fused and {n_layers} decode "
                             "launches per batch")

    x = torch.from_numpy(np.stack(images[:MAX_BATCH])).to(device)
    compare = {}
    # no pruning or quantization: no discrete decision can flip, so the
    # kernels and torch_gather agree up to float32 reassociation carried
    # through 6 blocks and 6 layers
    plain_cfg = slice_config("deformable-detr")
    plain_params = init_detector(plain_cfg, torch.Generator().manual_seed(SEED),
                                 device=device)
    with torch.inference_mode():
        a = detector_apply(plain_params, plain_cfg, x, backend="auto")
        g = detector_apply(plain_params, plain_cfg, x, backend="torch_gather")
    for i, label in ((0, "cls_logits"), (1, "boxes")):
        err = (a[i] - g[i]).abs()
        compare[f"deformable-detr/{label}"] = {"max": float(err.max()),
                                               "median": float(err.median())}
        if not torch.allclose(a[i], g[i], rtol=1e-4, atol=1e-4):
            raise AssertionError(f"deformable-detr {label}: auto vs torch_gather "
                                 f"max {float(err.max()):.3e} > 1e-4")
    with torch.inference_mode():
        a = detector_apply(engine.params, cfg, x, backend="auto")
        g = detector_apply(engine.params, cfg, x, backend="torch_gather")
    defa_agreement("deformable-detr-defa", a, g, compare)
    emit("serve", model="deformable-detr-defa", img=IMG, n_in=plan.n_in,
         requests=N_REQUESTS, batches=batches, wall_s=round(wall, 4),
         plan=plan.describe(), launches=launches,
         launches_per_batch={k: v // batches for k, v in launches.items()},
         auto_vs_torch_gather=compare)
    return {"params": engine.params, "cfg": cfg, "x": x, "launches": launches,
            "batches": batches, "fused_calls": rec_f.calls,
            "decode_calls": rec_d.calls}


def phase_serve_windowed(device):
    """The 1024 px bucket with an int8 value table through K3."""
    import numpy as np
    import torch
    from repro_torch.core.detector import detector_apply, init_detector
    from repro_torch.kernels import msgs_decode, msgs_fused, msgs_windowed
    from repro_torch.msda.plan import plan_for
    from repro_torch.serve import DetrServeEngine

    cfg = slice_config("deformable-detr-defa", IMG_WINDOWED, "int8")
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    images = seeded_images(N_REQUESTS, IMG_WINDOWED)
    enc_plan = plan_for(cfg.encoder.attn, cfg.level_shapes, "cuda_windowed")
    with DetrServeEngine(cfg, params, max_batch=MAX_BATCH,
                         backend="cuda_windowed", resolutions=(IMG_WINDOWED,),
                         device=device) as engine:
        dec_plan = engine.buckets[0].plan
        with Recorder(msgs_windowed, "msgs_windowed_msp", 6) as rec_w:
            msgs_windowed.LAUNCHES = 0
            msgs_decode.LAUNCHES = 0
            msgs_fused.LAUNCHES = 0
            reqs, wall = serve_requests(engine, images)
            launches = {"msgs_windowed": msgs_windowed.LAUNCHES,
                        "msgs_decode": msgs_decode.LAUNCHES,
                        "msgs_fused": msgs_fused.LAUNCHES}
        batches = engine.batches_dispatched
    check_requests(reqs)
    n_blocks, n_layers = cfg.encoder.n_blocks, cfg.decoder.n_layers
    if batches != N_REQUESTS // MAX_BATCH \
            or launches != {"msgs_windowed": n_blocks * batches,
                             "msgs_decode": n_layers * batches,
                             "msgs_fused": 0}:
        raise AssertionError(f"launch counts {launches} over {batches} batches; "
                             f"expected {n_blocks} windowed, {n_layers} decode "
                             "and 0 fused launches per batch")
    if enc_plan.backend != "cuda_windowed" or dec_plan.backend != "cuda_decode" \
            or enc_plan.table_dtype != "int8":
        raise AssertionError(f"plans {enc_plan.describe()} / "
                             f"{dec_plan.describe()}")

    # every served block's K3 output against torch_gather on the same
    # operands, within the kernel tolerance
    blocks = [check_close(f"msgs_windowed block {i} vs torch_gather",
                          msgs_windowed.msgs_windowed_msp(*args, **kw),
                          gather_on_k3_operands(args, kw),
                          tolerance(args[0].dtype, kw.get("scale")))
              for i, (args, kw) in enumerate(rec_w.calls)]

    x = torch.from_numpy(np.stack(images[:MAX_BATCH])).to(device)
    compare = {}
    with torch.inference_mode():
        w = detector_apply(engine.params, cfg, x, backend="cuda_windowed")
        # K1 and K3 sum each point's terms in the same order
        defa_agreement("cuda_windowed_vs_cuda_fused", w, detector_apply(
            engine.params, cfg, x, backend="cuda_fused"), compare)
        # At this size the discrete decisions of six blocks amplify any
        # float-ulp difference (the blocks agree above): hold K3 to
        # torch_gather as closely as torch_gather holds to itself when
        # its input images move by one ulp, twice that spread, and never
        # looser than the 1e-3 rule.
        g = detector_apply(engine.params, cfg, x, backend="torch_gather")
        spread = abs_errors(g, detector_apply(
            engine.params, cfg, torch.nextafter(x, torch.full_like(x, 2.0)),
            backend="torch_gather"))
        compare.update({f"torch_gather_vs_one_ulp_input/{k}": v
                        for k, v in spread.items()})
        defa_agreement("cuda_windowed_vs_torch_gather", w, g, compare,
                       median={k: max(1e-3, 2 * v["median"])
                               for k, v in spread.items()})
    emit("serve_1024", model="deformable-detr-defa", img=IMG_WINDOWED,
         table_dtype="int8", n_in=enc_plan.n_in, requests=N_REQUESTS,
         batches=batches, wall_s=round(wall, 4),
         encoder_plan=enc_plan.describe(), decoder_plan=dec_plan.describe(),
         tile_q=enc_plan.tile_q, window_bytes=enc_plan.window_bytes,
         window_bytes_compact=enc_plan.window_bytes_compact,
         launches=launches,
         launches_per_batch={k: v // batches for k, v in launches.items()},
         blocks_vs_torch_gather_max_abs_err=blocks, windowed_vs=compare)
    return {"params": engine.params, "cfg": cfg, "x": x, "launches": launches,
            "batches": batches, "windowed_calls": rec_w.calls}


def median_rel_diff(a, b):
    """Median over the elements of |a - b| / |b| (0 where a equals b)."""
    import torch
    diff = (a.double() - b.double()).abs()
    return float(torch.where(diff == 0, 0.0, diff / b.double().abs()).median())


def leaf_paths(tree, prefix=""):
    """(path, leaf) for every tensor of a param tree, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def phase_train(device):
    """Three AdamW steps of the full-width detector through K2 forward and
    backward, and the first step's gradients against torch_gather."""
    import torch
    from repro_torch.core.detector import init_detector
    from repro_torch.data.detection import synth_detection_batch
    from repro_torch.kernels import msgs_decode, msgs_fused, msgs_windowed
    from repro_torch.optim.adamw import OptConfig, adamw_init
    from repro_torch.train.detr import loss_and_grads, train_config, train_step

    # slice_config's model with the trainer's routing: torch_gather as the
    # encoder's own backend
    cfg = train_config("deformable-detr-defa", IMG)
    params0 = init_detector(cfg, torch.Generator().manual_seed(SEED),
                            device=device)
    batch = synth_detection_batch(torch.Generator().manual_seed(SEED),
                                  MAX_BATCH, IMG, cfg.level_shapes,
                                  cfg.n_classes, device=device)
    # DETR's AdamW settings: lr 1e-4, weight decay 1e-4, gradient clip 0.1
    opt_cfg = OptConfig(lr=1e-4, warmup_steps=0, total_steps=400,
                        weight_decay=1e-4, clip_norm=0.1)
    params, opt = params0, adamw_init(params0)
    steps, first_grads = [], None
    with Recorder(msgs_decode, "_backward", 1) as rec_b:
        msgs_decode.LAUNCHES = msgs_decode.LAUNCHES_BWD = 0
        msgs_fused.LAUNCHES = msgs_windowed.LAUNCHES = 0
        for i in range(TRAIN_STEPS):
            fwd0, bwd0 = msgs_decode.LAUNCHES, msgs_decode.LAUNCHES_BWD
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, metrics, grads = train_step(
                params, opt, batch, cfg, opt_cfg, backend="cuda_decode")
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            finite = all(bool(torch.isfinite(g).all()) for _, g in leaf_paths(grads))
            steps.append({"step": i + 1, "loss": float(metrics["loss"]),
                          "grad_norm": float(metrics["grad_norm"]),
                          "lr": float(metrics["lr"]), "wall_ms": wall,
                          "msgs_decode": msgs_decode.LAUNCHES - fwd0,
                          "msgs_decode_backward": msgs_decode.LAUNCHES_BWD - bwd0,
                          "max_memory_allocated": torch.cuda.max_memory_allocated(),
                          "grads_finite": finite})
            emit("train_step", **steps[-1])
            if first_grads is None:
                first_grads = grads
        launches = {"msgs_decode": msgs_decode.LAUNCHES,
                    "msgs_decode_backward": msgs_decode.LAUNCHES_BWD,
                    "msgs_fused": msgs_fused.LAUNCHES,
                    "msgs_windowed": msgs_windowed.LAUNCHES}
    n_layers = cfg.decoder.n_layers
    if launches != {"msgs_decode": n_layers * TRAIN_STEPS,
                    "msgs_decode_backward": n_layers * TRAIN_STEPS,
                    "msgs_fused": 0, "msgs_windowed": 0}:
        raise AssertionError(f"train launch counts {launches}; expected "
                             f"{n_layers} K2 forward and {n_layers} backward "
                             "launches per step and no K1 or K3")
    if not all(math.isfinite(st["loss"]) and st["grads_finite"] for st in steps):
        raise AssertionError(f"non-finite loss or gradient: {steps}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"loss did not fall on the repeated batch: {steps}")
    dead = [p for p, g in leaf_paths(first_grads["decoder"])
            if ("/cross/" in p or p.startswith("/value/"))
            and not float(g.abs().sum()) > 0]
    if dead:
        raise AssertionError(f"decoder leaves without gradient: {dead}")

    # the first step again through torch_gather, and torch_gather's own
    # spread when the input images move by one ulp
    img = batch[0]
    nudged = (torch.nextafter(img, torch.full_like(img, 2.0)), *batch[1:])
    _, _, g_gather = loss_and_grads(params0, cfg, batch, backend="torch_gather")
    _, _, g_spread = loss_and_grads(params0, cfg, nudged, backend="torch_gather")
    # A leaf whose exact gradient is 0 carries only float roundoff on both
    # sides (the self-attention key bias: it adds the same q.b to every
    # logit of a softmax row); its relative differences are noise, so it
    # is held in absolute terms, to 1e-6 of the largest gradient.
    g_max = max(float(b.abs().max()) for _, b in leaf_paths(g_gather))
    per_leaf, roundoff = [], []
    for (path, a), (_, b), (_, c) in zip(leaf_paths(first_grads),
                                         leaf_paths(g_gather),
                                         leaf_paths(g_spread)):
        if float(b.abs().max()) <= 1e-6 * g_max:
            roundoff.append({"leaf": path, "max_abs": float(b.abs().max()),
                             "max_abs_diff": float((a - b).abs().max())})
            continue
        per_leaf.append({"leaf": path, "vs_torch_gather": median_rel_diff(a, b),
                         "one_ulp_spread": median_rel_diff(c, b)})
    if any(r["max_abs_diff"] > 1e-6 * g_max for r in roundoff):
        raise AssertionError(f"roundoff-only gradient leaves differ by more "
                             f"than 1e-6 of the largest gradient: {roundoff}")
    rule = "median relative difference <= 1e-3 per leaf"
    bad = [r for r in per_leaf if not r["vs_torch_gather"] <= 1e-3]
    if bad:
        rule = "median relative difference <= max(1e-3, 2 x one-ulp spread)"
        bad = [r for r in per_leaf if not r["vs_torch_gather"]
               <= max(1e-3, 2 * r["one_ulp_spread"])]
    worst = sorted(per_leaf, key=lambda r: -r["vs_torch_gather"])[:8]
    if bad:
        raise AssertionError(f"first-step gradients, cuda_decode vs "
                             f"torch_gather: {bad[:8]}")
    emit("train", model="deformable-detr-defa", img=IMG, batch=MAX_BATCH,
         encoder_backend=cfg.encoder.attn.backend, backend="cuda_decode",
         steps=steps, launches=launches,
         launches_per_step={k: v // TRAIN_STEPS for k, v in launches.items()},
         grad_rule_held=rule, leaves=len(per_leaf), worst_leaves=worst,
         roundoff_leaves=roundoff, largest_gradient=g_max,
         max_vs_torch_gather=max(r["vs_torch_gather"] for r in per_leaf),
         max_one_ulp_spread=max(r["one_ulp_spread"] for r in per_leaf))
    return {"cfg": cfg, "params": params, "opt": opt, "opt_cfg": opt_cfg,
            "batch": batch, "launches": launches, "steps": TRAIN_STEPS,
            "backward_calls": rec_b.calls}


# --------------------------------------------------------------------------
# phase 5: times and bounds on the main path's own operands
# --------------------------------------------------------------------------

def cuda_ms(fn, reps, inner):
    """Median over ``reps`` of CUDA-event time per call of ``inner``
    back-to-back calls, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _device_us(evt):
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def profile(fn, calls=1):
    """torch.profiler over ``calls`` calls of ``fn`` after a warm-up:
    (device kernel events, cpu op events, wall ms). Device events are the
    kernels on the card, with their own durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    return dev, cpu, wall


def kernel_device_ms(fn, kernel_name, calls=20):
    """Device time of one launch of ``kernel_name`` (profiler, CUPTI);
    None when the profiler records no device time on this machine."""
    dev, _, _ = profile(fn, calls)
    hits = [e for e in dev if kernel_name in e.key]
    total = sum(_device_us(e) for e in hits)
    count = sum(e.count for e in hits)
    return total / count / 1e3 if count and total > 0 else None


def forward_profile(fn):
    """Where one forward's time goes: device busy ms, wall ms, and the
    top kernels by device time and ops by host time."""
    dev, cpu, wall = profile(fn)
    busy = sum(_device_us(e) for e in dev) / 1e3
    top = lambda evts, key: [
        {"op": e.key[:90], "count": e.count, "ms": round(key(e) / 1e3, 4)}
        for e in sorted(evts, key=key, reverse=True)[:12]]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if wall <= 0 else max(0.0, 1 - busy / wall),
            "n_kernels": sum(e.count for e in dev),
            "top_device": top(dev, _device_us),
            "top_host": top(cpu, lambda e: float(e.self_cpu_time_total))}


def touched(pts, remap, n_rows, h):
    """What the live points of one call read: distinct (batch, head,
    table row) triples, distinct (batch, pixel) pairs (the pix2slot
    entries under a remap), and the live point count."""
    import torch
    from repro_torch.msda.sampling import corner_data
    x, y, st, wl, hl, p = pts
    idx, _, valid = corner_data(x, y, wl, hl, st)            # (..., 4)
    live = valid & (p > 0)[..., None]
    b = x.shape[0]
    pix = idx.reshape(b, -1).long()
    row = pix if remap is None else torch.gather(remap.long(), 1, pix)
    heads = torch.arange(x.shape[-2], device=x.device).view(
        *([1] * (x.dim() - 2)), -1, 1, 1).expand(x.shape + (4,)).reshape(b, -1)
    bidx = torch.arange(b, device=x.device)[:, None]
    live = live.reshape(b, -1)
    rows = torch.unique(((bidx * h + heads) * n_rows + row)[live]).numel()
    n_pix = int(pix.max()) + 1
    pixels = torch.unique((bidx * n_pix + pix)[live]).numel()
    return int(rows), int(pixels), int(live.reshape(x.shape + (4,)).any(-1).sum())


def kernel_bound(pts, remap, scale, out, n_rows, h, dh, itemsize,
                 operands=None):
    """Least time for the same work: every input byte read once (table:
    the rows the live points touch), every output byte written once, and
    the Eq. 4 operations of the live points at the float32 rate. The
    point operands are ``operands`` (default ``pts``). K1 and K2 count
    their whole ``remap``; K3 (``operands`` given) counts the pix2slot
    entries its live points touch."""
    rows, pixels, live_points = touched(pts, remap, n_rows, h)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (pts if operands is None else operands))
    nbytes += rows * dh * itemsize + out.numel() * out.element_size()
    if remap is not None:
        nbytes += (remap.numel() if operands is None else pixels) \
            * remap.element_size()
    if scale is not None:
        nbytes += scale.numel() * scale.element_size()
    ops = live_points * dh * FLOPS_PER_CHANNEL_POINT
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "table_rows_touched": rows,
            "pixels_touched": pixels}


def kernel_times(call, plain, kernel_name):
    """``ms``: the kernel's own time on the card (profiler device time per
    launch; CUDA events over back-to-back calls where the profiler sees no
    device time). ``call_ms``: CUDA events per wrapper call, host checks
    and launch included. ``plain_ms``: the plain version, CUDA events."""
    call_ms = cuda_ms(call, 11, 20)
    dev_ms = kernel_device_ms(call, kernel_name)
    return {"ms": dev_ms if dev_ms is not None else call_ms,
            "ms_source": "profiler" if dev_ms is not None else "cuda_events",
            "call_ms": call_ms, "plain_ms": cuda_ms(plain, 5, 1)}


def forward_ms(serve, backend, reps=5):
    """Median host time of one B = 2 forward, ending in a synchronize."""
    import torch
    from repro_torch.core.detector import detector_apply

    def run():
        with torch.inference_mode():
            detector_apply(serve["params"], serve["cfg"], serve["x"],
                           backend=backend)
        torch.cuda.synchronize()
    run()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def serve_profile(serve, backend):
    import torch
    from repro_torch.core.detector import detector_apply

    def forward():
        with torch.inference_mode():
            detector_apply(serve["params"], serve["cfg"], serve["x"],
                           backend=backend)
    return forward_profile(forward)


def backward_bound(pts, remap, scale, g_out, vp, h, dh):
    """Least time for K2's backward: the points, g_out, the whole remap and
    the table rows that the valid corners touch read once; the dense
    float32 d_vp (or d_scale) and the three point gradients written
    once; the operations of ``FLOPS_PER_CHANNEL_CORNER_*``."""
    import torch
    from repro_torch.msda.sampling import corner_data
    x, y, st, wl, hl, p = pts
    _, valid = corner_data(x, y, wl, hl, st)[1:]
    n_valid = int(valid.sum())
    n_live = int((valid & (p > 0)[..., None]).sum())
    rows, _, _ = touched((x, y, st, wl, hl, torch.ones_like(p)), remap,
                         vp.shape[2], h)
    nbytes = sum(t.numel() * t.element_size() for t in pts)
    nbytes += g_out.numel() * 4 + rows * dh * vp.element_size()
    nbytes += 3 * x.numel() * 4
    if remap is not None:
        nbytes += remap.numel() * remap.element_size()
    if scale is None:
        nbytes += vp.numel() * 4
    else:
        nbytes += 2 * scale.numel() * scale.element_size()
    ops = dh * (FLOPS_PER_CHANNEL_CORNER_DOT * n_valid
                + FLOPS_PER_CHANNEL_CORNER_SCATTER * n_live)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "table_rows_touched": rows,
            "valid_corners": n_valid, "live_corners": n_live}


def train_step_ms(train, reps=5):
    """Median host time of one train step at B = 2 (the same params and
    batch each time), ending in a synchronize, after one warm-up."""
    import torch
    from repro_torch.train.detr import train_step

    def run():
        train_step(train["params"], train["opt"], train["batch"], train["cfg"],
                   train["opt_cfg"], backend="cuda_decode")
        torch.cuda.synchronize()
    run()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), run


def phase_times(serve, serve_w, train):
    from repro_torch.kernels import msgs_decode, msgs_fused, msgs_windowed
    kernels = []
    # K1: the last encoder block's call (compact table, pix2slot remap)
    args, kw = serve["fused_calls"][-1]
    v, pts = args[0], args[1:7]
    remap, scale = kw.get("remap"), kw.get("scale")
    out = msgs_fused.msgs_fused(v, *pts, remap=remap, scale=scale)
    plain = msgs_fused.msgs_fused_plain(v, *pts, remap=remap, scale=scale)
    err = check_close("msgs_fused main path", out, plain,
                      tolerance(v.dtype, scale))
    k1 = {"name": "msgs_fused", "route": "cuda",
          "source": "src/repro_torch/csrc/msgs_fused.cu",
          "replaces": "src/repro/kernels/msgs_fused.py:145",
          "launches": serve["launches"]["msgs_fused"], "max_abs_err": err,
          **kernel_times(
              lambda: msgs_fused.msgs_fused(v, *pts, remap=remap, scale=scale),
              lambda: msgs_fused.msgs_fused_plain(v, *pts, remap=remap,
                                                  scale=scale),
              "msgs_fused_kernel"),
          "library_ms": None}
    b1 = kernel_bound(pts, remap, scale, out, v.shape[1], v.shape[2],
                      v.shape[3], v.element_size())
    k1.update(bound_ms=b1["bound_ms"], bound_by=b1["bound_by"])
    kernels.append(k1)
    detail = {"msgs_fused": dict(b1, shape=list(pts[0].shape),
                                 table=list(v.shape), dtype=str(v.dtype))}

    # K2: the first decoder layer's call on the once-staged table
    args, kw = serve["decode_calls"][0]
    staged, pts = args[0], args[1:7]
    out = msgs_decode.msgs_decode(staged, *pts)
    layered = tuple(t[:, None] for t in pts)
    plain = msgs_decode.msgs_decode_plain(
        staged.v, *layered, staged.remap, staged.scale,
        head_pack=staged.head_pack, dh=staged.dh)[:, 0]
    err = check_close("msgs_decode main path", out, plain,
                      tolerance(staged.v.dtype, staged.scale))
    k2 = {"name": "msgs_decode", "route": "cuda",
          "source": "src/repro_torch/csrc/msgs_decode.cu",
          "replaces": "src/repro/kernels/msgs_decode.py:231",
          "launches": serve["launches"]["msgs_decode"], "max_abs_err": err,
          **kernel_times(
              lambda: msgs_decode.msgs_decode(staged, *pts),
              lambda: msgs_decode.msgs_decode_plain(
                  staged.v, *layered, staged.remap, staged.scale,
                  head_pack=staged.head_pack, dh=staged.dh),
              "msgs_decode_kernel"),
          "library_ms": None}
    h = pts[0].shape[2]
    # staged rows are per head group; count (b, head, row) like K1
    b2 = kernel_bound(pts, staged.remap, staged.scale, out, staged.n_rows, h,
                      staged.dh, staged.v.element_size())
    k2.update(bound_ms=b2["bound_ms"], bound_by=b2["bound_by"])
    kernels.append(k2)
    detail["msgs_decode"] = dict(b2, shape=list(pts[0].shape),
                                 table=list(staged.v.shape),
                                 dtype=str(staged.v.dtype))

    # K3: the last encoder block's call at 1024 px (int8 compact table)
    args, kw = serve_w["windowed_calls"][-1]
    v, pts = args[0], args[1:5]
    call = lambda: msgs_windowed.msgs_windowed_msp(*args, **kw)
    out = call()
    err = check_close("msgs_windowed main path", out,
                      msgs_windowed.msgs_windowed_msp_plain(*args, **kw),
                      tolerance(v.dtype, kw.get("scale")))
    k3 = {"name": "msgs_windowed", "route": "cuda",
          "source": "src/repro_torch/csrc/msgs_windowed.cu",
          "replaces": "src/repro/kernels/msgs_windowed.py:318",
          "launches": serve_w["launches"]["msgs_windowed"], "max_abs_err": err,
          **kernel_times(call,
                         lambda: msgs_windowed.msgs_windowed_msp_plain(*args,
                                                                       **kw),
                         "msgs_windowed_kernel"),
          "library_ms": None}
    st, wl, hl = level_operands(pts[2], kw["level_shapes"])
    b3 = kernel_bound((pts[0], pts[1], st, wl, hl, pts[3]), kw.get("remap"),
                      kw.get("scale"), out, v.shape[1], v.shape[2], v.shape[3],
                      v.element_size(), operands=pts)
    k3.update(bound_ms=b3["bound_ms"], bound_by=b3["bound_by"])
    kernels.append(k3)
    # K1 on the same operands: does windowing pay on this card?
    k1_call = k1_on_k3_operands(args, kw)
    k1_dev = kernel_device_ms(k1_call, "msgs_fused_kernel")
    detail["msgs_windowed"] = dict(
        b3, shape=list(pts[0].shape), table=list(v.shape), dtype=str(v.dtype),
        tile_q=kw["tile_q"], head_pack=kw["head_pack"],
        k1_same_operands={"ms": k1_dev, "call_ms": cuda_ms(k1_call, 11, 20),
                          "max_abs_diff_vs_k3":
                              float((k1_call() - out).abs().max())})

    # K2 backward: the first backward call of the first train step (the
    # last decoder layer), on the operands autograd gave it
    args, kw = train["backward_calls"][0]
    vp, pts, g_out, remap, scale, g, dh = (args[0], args[1:7], args[7], args[8],
                                           args[9], args[10], args[11])
    staged = msgs_decode.DecodeStagedTable(v=vp, remap=remap, n_rows=vp.shape[2],
                                           head_pack=g, dh=dh, table_bytes=0,
                                           scale=scale)
    call = lambda: msgs_decode.msgs_decode_backward(staged, *pts, g_out)
    plain = lambda: msgs_decode.msgs_decode_backward_plain(
        vp, *pts, g_out, remap, scale, head_pack=g, dh=dh)
    errs = check_backward("main path", call(), plain(), vp.dtype, scale)
    kb = {"name": "msgs_decode_backward", "route": "cuda",
          "source": "src/repro_torch/csrc/msgs_decode_bwd.cu",
          "replaces": "src/repro/kernels/msgs_decode.py:350",
          "launches": train["launches"]["msgs_decode_backward"],
          "max_abs_err": max(errs.values()),
          **kernel_times(call, plain, "msgs_decode_backward_kernel"),
          "library_ms": None}
    h = pts[0].shape[3]
    bb = backward_bound(pts, remap, scale, g_out, vp, h, dh)
    kb.update(bound_ms=bb["bound_ms"], bound_by=bb["bound_by"])
    kernels.append(kb)
    dev, _, _ = profile(call, 20)
    detail["msgs_decode_backward"] = dict(
        bb, shape=list(pts[0].shape), table=list(vp.shape), dtype=str(vp.dtype),
        max_abs_err_by_output=errs,
        wrapper_device_ms=sum(_device_us(e) for e in dev) / 20 / 1e3)

    step_ms, step = train_step_ms(train)
    times = {"train_step_ms_b2": step_ms,
             "serve_forward_ms_b2": forward_ms(serve, "auto"),
             "torch_gather_forward_ms_b2": forward_ms(serve, "torch_gather"),
             "serve_1024_forward_ms_b2": forward_ms(serve_w, "cuda_windowed"),
             "torch_gather_1024_forward_ms_b2": forward_ms(
                 serve_w, "torch_gather", reps=3)}
    for k in kernels:
        detail[k["name"]].update(ms_source=k.pop("ms_source"),
                                 call_ms=k.pop("call_ms"))
    batches = {"msgs_fused": serve["batches"], "msgs_decode": serve["batches"],
               "msgs_windowed": serve_w["batches"],
               "msgs_decode_backward": train["steps"]}
    emit("times", kernels=detail, library_ms=None, library_note=LIBRARY_NOTE,
         **times, forward_profile=serve_profile(serve, "auto"),
         forward_profile_1024=serve_profile(serve_w, "cuda_windowed"),
         train_step_profile=forward_profile(step),
         train_launches_per_step={k: v // train["steps"]
                                  for k, v in train["launches"].items()},
         launches_per_forward={k["name"]: k["launches"] // batches[k["name"]]
                               for k in kernels},
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                "f32_flop_per_s": F32_FLOP_PER_S})
    return kernels


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port package under {src}; run from a checkout "
              "of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    # parity and timing run in full float32: no TF32 in matmul or conv
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)

    phase_device()
    phase_build()
    from repro_torch.msda.plan import level_shapes_for_resolution
    phase_kernel_checks(device, level_shapes_for_resolution(IMG))
    phase_windowed_checks(device)
    phase_decode_grad(device, level_shapes_for_resolution(IMG))
    serve = phase_serve(device)
    serve_w = phase_serve_windowed(device)
    train = phase_train(device)
    kernels = phase_times(serve, serve_w, train)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
