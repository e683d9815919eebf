#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  1. device   — torch / CUDA versions, the card's name and power limit;
  2. build    — the six Hopper kernel libraries built from
                ``src/repro_torch/csrc`` with nvcc for sm_90a (one nvcc per
                source, started together); ptxas registers, shared memory
                and spills per kernel, and the HGMMA (wgmma) and UTMALDG
                (TMA load) counts of libmatmul.so and libflash_decode.so
                from ``cuobjdump -sass`` (K4 must have both);
  3. kernels  — K1 and K2 against their plain PyTorch versions on the card:
                {f32, bf16, int8 + scale} tables x {dense, compact remap}
                at the 512 px path's shapes, a ragged small shape, Dh
                12/16/32/64 (Dh 12: rows of 48, 24 and 12 B, which K1's
                gather plan serves with 16, 8 and 4 B vectors);
     windowed — K3 against its plain version: the same tables x {dense,
                compact with keep_idx} at the 1024 px path's shape and on a
                ragged small pyramid (Dh 16 and 64, head_pack 1; Dh 12,
                head_pack 2), with points up to three range bounds from
                their reference, so that the windows drop corners;
     decode_grad — K2's backward kernel against its closed-form plain
                version: the same tables x {dense, compact} x head_pack
                {1, 4} x L {1, 3} at the 512 px decoder's shape and a
                ragged small one, with points on integer coordinates and
                outside their level; K2's output carries a grad_fn under
                autograd, and the forward-only K1 and K3 refuse it;
     lm_kernels — K5 (flash-decode) and K4 (matmul) against their plain
                versions: K5 in f32 and bf16 on the reference's sweep, the
                slice's decode shape (B 4, Hq 24, Hkv 8, Dh 128, W 4096),
                a ragged W, Hkv not dividing Hq, MQA, ring-buffer masks,
                rows with no valid slot and K5's split edges (W not a
                multiple of the split, splits with no valid slot, one
                valid slot at W - 1, B * Hkv = 1), each with its split
                plan; K4 in f32, bf16 and int8 + scale on the reference's
                shapes, minitron-4b's prefill and decode MLP-up products
                and the wgmma route's edges (M 1 and 65, K 3000, int8 with
                N % 16 == 0 or not), each with its route (the bf16 and int8
                prefill products must take "wgmma");
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
                live decoder gradients, the first step's gradients
                against the same step through torch_gather, and whether
                two identical gradient passes agree bitwise (K2's backward
                adds with float32 atomics);
     lm_serve — minitron-4b at its published width and depth (bf16,
                random weights drawn on the card from the seed) served by
                ServeEngine (max_batch 4, cache_len 4096): 4 prompts of 37,
                128, 300 and 512 tokens, 16 greedy tokens each; launch
                counters (32 K5 per decode step, no K4), tokens in range,
                finite logits, peak memory, the next decode step's logits
                through K5 against the plain attention, and how often the
                greedy streams agree with a plain-attention run;
  5. times    — each kernel and its plain version on the operands its
                path gave it, their bounds and the library call where one
                exists, K1's and K3's L2 gather bytes, K1 on K3's operands,
                one serve forward at B = 2 per path, one train step, one LM
                decode step at B = 4 and one 512-token prefill, each with
                its idle share.

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
# ... and the dense bf16 tensor-core rate
BF16_FLOP_PER_S = 989e12
# Eq. 4 per channel per live point: 5 add/sub + 3 mul inside the corner
# differences, 3 add/mul to combine them, then p * S + acc.
FLOPS_PER_CHANNEL_POINT = 13
# K2 backward per channel: <v_c, g> (multiply, add) for every valid corner
# of every point, and p w_c g (multiply) plus its atomic add for every
# valid corner of a live point.
FLOPS_PER_CHANNEL_CORNER_DOT = 2
FLOPS_PER_CHANNEL_CORNER_SCATTER = 2
# L2 serves global loads in 32-byte sectors
SECTOR_BYTES = 32
TRAIN_STEPS = 3
IMG = 512
IMG_WINDOWED = 1024              # the bucket the reference serves with K3
MAX_BATCH = 2
N_REQUESTS = 4
SEED = 0
LM_ARCH = "minitron-4b"          # published width and depth, bf16
LM_MAX_BATCH = 4
LM_CACHE_LEN = 4096              # minitron's context length
LM_PROMPTS = (37, 128, 300, 512)
LM_NEW_TOKENS = 16
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
        limit = {key: lim if isinstance(lim, (int, float))
                 else f"per row, at most {float(lim.max()):.3e}"
                 for key, lim in tol.items()}
        raise AssertionError(f"{name}: {int(bad.sum())} elements beyond "
                             f"{limit}; max abs err {float(err.max()):.3e}")
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


def ptxas_per_kernel(log):
    """{demangled-ish kernel entry: "registers, smem, spills"} from the
    ``-Xptxas -v`` lines of one nvcc log."""
    per, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.strip()
        elif name and ("registers" in ln or "spill" in ln):
            per[name] = (per.get(name, "") + " " + ln.split(":", 1)[-1].strip()).strip()
    return per


def sass_counts(lib):
    """Counts of the Hopper instructions that show the design in one
    library's SASS: HGMMA (wgmma) and UTMALDG (a TMA tile load)."""
    from repro_torch.kernels.build import nvcc_path
    dump = Path(nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(dump), "-sass", lib], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}


def phase_build():
    from repro_torch.kernels.build import build_dir, build_kernels
    t0 = time.perf_counter()
    info = build_kernels()
    seconds = time.perf_counter() - t0
    sass = {n: sass_counts(info[n]["path"]) for n in ("matmul", "flash_decode")}
    if not (sass["matmul"]["HGMMA"] and sass["matmul"]["UTMALDG"]):
        raise AssertionError(f"libmatmul.so lacks wgmma or TMA: {sass['matmul']}")
    emit("build", seconds=round(seconds, 3),
         per_kernel_seconds={n: round(i["seconds"], 3) for n, i in info.items()},
         dir=str(build_dir()), sass=sass,
         ptxas={n: ptxas_per_kernel(i["log"]) for n, i in info.items()})


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
              ("dh64", small_levels, 2, 50, 30, 2, 4, 64, 300),
              ("ragged_dh12", small_levels, 2, 45, 19, 4, 4, 12, 300)]
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
              ("ragged_dh64", ragged, 2, 2, 4, 64, small_ranges, 1),
              ("ragged_dh12", ragged, 2, 4, 4, 12, small_ranges, 2)]
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


def ring_valid(gen, b, w, window=0, empty_rows=()):
    """(B, W) slot validity of a ring-buffer cache: each row at a random
    position in [0, 3 W) holds the positions (pos - window, pos] that its
    W slots still keep (window 0: all of them); ``empty_rows`` hold no
    valid slot."""
    import torch
    pos = torch.randint(0, 3 * w, (b, 1), generator=gen)
    latest = pos - (pos - torch.arange(w)) % w         # newest position per slot
    win = window if window > 0 else 3 * w
    valid = (latest >= 0) & (latest > pos - win)
    valid[list(empty_rows)] = False
    return valid


def k5_operands(gen, b, hq, hkv, dh, w, dtype, mask, device):
    import torch
    q = torch.randn((b, hq, dh), generator=gen)
    k = torch.randn((b, w, hkv, dh), generator=gen)
    v = torch.randn((b, w, hkv, dh), generator=gen)
    if mask == "sweep":                     # the reference's: slot 0 valid
        valid = torch.rand((b, w), generator=gen) < 0.7
        valid[:, 0] = True
    elif mask == "full":
        valid = torch.ones((b, w), dtype=torch.bool)
    else:                                   # ring, ring_window, ring_empty
        valid = ring_valid(gen, b, w, w // 3 if mask == "ring_window" else 0,
                           (0,) if mask == "ring_empty" else ())
    return [t.to(dtype).contiguous().to(device) for t in (q, k, v)] + \
        [valid.to(device)]


def k4_operands(gen, m, k, n, kind, device):
    """x, w, w_scale: float32 or bf16 x and w, or int8 w codes with their
    per-column scale ("int8": x float32 on the small shapes, bf16 on the
    model's; "int8_bf16x": x bf16 always)."""
    import torch
    x = torch.randn((m, k), generator=gen)
    w = torch.randn((k, n), generator=gen)
    scale = None
    if kind == "bfloat16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    elif kind in ("int8", "int8_bf16x"):
        scale = w.abs().amax(0, keepdim=True) / 127
        w = (w / scale).round().clamp(-127, 127).to(torch.int8)
        if k >= 1024 or kind == "int8_bf16x":
            x = x.to(torch.bfloat16)
    as_dev = lambda t: None if t is None else t.contiguous().to(device)
    return as_dev(x), as_dev(w), as_dev(scale)


def matmul_tolerance(x, w, scale):
    """K4 vs plain: the two sum K in other orders, so atol 2^-20 of the
    largest absolute sum |x| @ |w|; a bf16 output adds rtol 2^-7 (one
    bf16 rounding step)."""
    import torch
    from repro_torch.kernels.matmul import dequantized
    big = float((x.float().abs() @ dequantized(w, scale).abs()).max())
    return {"rtol": 2 ** -7 if x.dtype == torch.bfloat16 else 0.0,
            "atol": 2 ** -20 * big}


# (label, B, Hq, Hkv, Dh, W, chunk, mask): the reference's sweep (chunk
# 64), the slice's decode shape, a ragged W with a row that has no valid
# slot, Hkv not dividing Hq, an MQA shape of 12 head groups; then K5's
# splits: W not a multiple of the split, splits with no valid slot in rows
# that have valid slots, a single valid slot at W - 1, B * Hkv = 1, and
# the LM's shape with K and V two bytes off a 16-byte boundary (the split
# pass that reads rows element by element, in both dtypes)
K5_CASES = [("sweep_a", 2, 8, 2, 32, 100, 64, "sweep"),
            ("sweep_b", 1, 4, 4, 64, 513, 64, "sweep"),
            ("sweep_c", 3, 25, 5, 16, 64, 64, "sweep"),
            ("sweep_d", 2, 48, 8, 32, 257, 64, "sweep"),
            ("slice", 4, 24, 8, 128, 4096, 512, "ring"),
            ("ragged_w_empty_row", 4, 24, 8, 128, 1000, 512, "ring_empty"),
            ("hq6_hkv4", 2, 6, 4, 64, 300, 64, "ring_window"),
            ("mqa_hq48", 2, 48, 1, 128, 777, 256, "ring_empty"),
            ("w_not_split_multiple", 4, 24, 8, 128, 4000, 512, "ring"),
            ("empty_splits", 4, 24, 8, 128, 4096, 512, "prefix"),
            ("last_slot_only", 4, 24, 8, 128, 1000, 512, "last"),
            ("b1_hkv1", 1, 4, 1, 128, 2048, 512, "ring_window"),
            ("unaligned_rows", 4, 24, 8, 128, 4000, 512, "ring")]
# (label, M, K, N, kinds): the reference's sweep and int8 shapes,
# minitron-4b's prefill (2048 tokens) and decode (B = 4) MLP-up products;
# then the wgmma route's edges: an aligned small shape, M 1 (a split K) and
# 65 (across a tile edge), K 3000 (not a multiple of the K step of 64),
# int8 codes with N % 16 == 0 (wgmma) and N % 16 == 8 (simt)
K4_KINDS = ("float32", "bfloat16", "int8")
K4_CASES = [("sweep_a", 70, 90, 50, K4_KINDS), ("sweep_b", 128, 128, 128, K4_KINDS),
            ("sweep_c", 33, 257, 65, K4_KINDS), ("int8_ref", 64, 96, 48, K4_KINDS),
            ("prefill_mlp_up", 2048, 3072, 9216, K4_KINDS),
            ("decode_mlp_up", 4, 3072, 9216, K4_KINDS),
            ("aligned_small", 96, 256, 192, ("bfloat16", "int8_bf16x")),
            ("m1", 1, 1024, 512, ("bfloat16", "int8_bf16x")),
            ("m65", 65, 512, 384, ("bfloat16", "int8_bf16x")),
            ("k3000", 128, 3000, 256, ("bfloat16", "int8_bf16x")),
            ("int8_n_mod16_8", 96, 256, 200, ("bfloat16", "int8_bf16x"))]
# K5's split-edge cases (the last five above). Their float32 runs are held
# to the kernel tolerance (1e-5: no score rounding in float32). Their bf16
# runs keep rtol 2^-7 and take atol 2^-8 of the largest |output| of each
# (b, h) row: a bf16 score is an f32 sum rounded to bf16, the kernel and
# the plain version sum in other orders, and where a score lands on the
# other side of a rounding boundary its softmax weight moves by
# exp(scale * ulp) - 1 (about 1 % for scores of 16 to 32). That moves
# every channel of the row by the same share of its V, so a channel near
# zero may move by many of its own bf16 steps, but not by half a step of
# the row's largest output. Dropping the ragged last split of
# w_not_split_multiple's bf16 run (a planted fault, PERF.md §6) breaks
# this limit.
K5_SPLIT_EDGE_CASES = {"w_not_split_multiple", "empty_splits", "last_slot_only",
                       "b1_hkv1", "unaligned_rows"}
# cases whose route is fixed by the contract of this kernel
K4_MUST_ROUTE = {"prefill_mlp_up/bfloat16": "wgmma", "prefill_mlp_up/int8": "wgmma",
                 "decode_mlp_up/bfloat16": "wgmma", "int8_n_mod16_8/int8_bf16x": "simt",
                 "sweep_a/bfloat16": "simt", "prefill_mlp_up/float32": "simt"}


def k5_row_tolerance(want):
    """bf16 runs of K5's split-edge cases: rtol 2^-7 and, per (b, h) row,
    atol 2^-8 of the row's largest |output| (see K5_SPLIT_EDGE_CASES)."""
    return {"rtol": 2 ** -7,
            "atol": 2 ** -8 * want.float().abs().amax(-1, keepdim=True)}


def k5_mask(gen, b, w, mask):
    """The slot validity of one K5 case: ``k5_operands``'s masks plus
    "prefix" (row i valid in its first 100 + 900 i slots only, so later
    splits hold none) and "last" (one valid slot, at W - 1)."""
    import torch
    if mask == "prefix":
        return torch.arange(w)[None] < (100 + 900 * torch.arange(b))[:, None]
    valid = torch.zeros((b, w), dtype=torch.bool)
    valid[:, w - 1] = True
    return valid


def off_by_two(t):
    """A contiguous copy of ``t`` whose data starts two bytes past a
    16-byte boundary."""
    import torch
    flat = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
    return flat[1:1 + t.numel()].view(t.shape).copy_(t)


def phase_lm_kernels(device):
    """K5 and K4 against their plain versions on the card, with K5's
    split plan and K4's route per case."""
    import torch
    from repro_torch.kernels import flash_decode, matmul
    from repro_torch.kernels.msgs_fused import sm_count
    gen = torch.Generator().manual_seed(SEED + 3)
    k5 = []
    for label, b, hq, hkv, dh, w, chunk, mask in K5_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, valid = k5_operands(gen, b, hq, hkv, dh, w, dtype,
                                         mask if mask not in ("prefix", "last")
                                         else "full", device)
            if mask in ("prefix", "last"):
                valid = k5_mask(gen, b, w, mask).to(device)
            if label == "unaligned_rows":
                k, v = off_by_two(k), off_by_two(v)
            case = f"{label}/{str(dtype)[6:]}"
            want = flash_decode.flash_decode_plain(q, k, v, valid, chunk=chunk)
            tol = (k5_row_tolerance(want) if label in K5_SPLIT_EDGE_CASES
                   and dtype == torch.bfloat16 else tolerance(dtype, None))
            err = check_close(f"flash_decode {case}",
                              flash_decode.flash_decode(q, k, v, valid, chunk=chunk),
                              want, tol)
            length, n_splits = flash_decode.decode_splits(
                b, hkv, flash_decode.head_groups(hq, hkv), w, sm_count(q.device))
            per_split = torch.nn.functional.pad(
                valid, (0, n_splits * length - w)).reshape(b, n_splits, length).any(-1)
            k5.append({"case": case, "pad": flash_decode.chunk_padding(w, chunk),
                       "split_len": length, "splits": n_splits,
                       "rows_without_valid_slot": int((~valid.any(1)).sum()),
                       "empty_splits_in_rows_with_valid_slots":
                           int((~per_split & valid.any(1, keepdim=True)).sum()),
                       "max_abs_err": err})
    k4 = []
    for label, m, kk, n, kinds in K4_CASES:
        for kind in kinds:
            x, w, scale = k4_operands(gen, m, kk, n, kind, device)
            case = f"{label}/{kind}"
            route = matmul.matmul_route(x, w, scale)
            if K4_MUST_ROUTE.get(case, route) != route:
                raise AssertionError(f"matmul {case}: route {route}, expected "
                                     f"{K4_MUST_ROUTE[case]}")
            err = check_close(f"matmul {case}", matmul.matmul(x, w, scale),
                              matmul.matmul_plain(x, w, scale),
                              matmul_tolerance(x, w, scale))
            k4.append({"case": case, "x": str(x.dtype), "route": route,
                       "splits": matmul.matmul_splits(m, n, kk, sm_count(x.device))
                       if route == "wgmma" else None, "max_abs_err": err})
    emit("lm_kernels", checks=len(k5) + len(k4), flash_decode=k5, matmul=k4,
         tolerance="flash_decode: f32 1e-5, bf16 rtol 2^-7 atol 1e-5 (the split-"
                   "edge cases in bf16: atol 2^-8 of each (b, h) row's largest "
                   "|output|); matmul: atol 2^-20*max(|x|@|w|), bf16 output "
                   "rtol 2^-7")


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


def bitwise_rerun(params, cfg, batch, backward_call):
    """Whether two identical gradient passes agree bit for bit, and one K2
    backward call twice on the same operands. K2's backward adds the table
    and scale gradients with float32 atomics (csrc/msgs_decode_bwd.cu),
    the encoder's torch_gather backward with index_add_; either may add
    in another order on every run. Recorded, not required."""
    import torch
    from repro_torch.kernels import msgs_decode
    from repro_torch.train.detr import loss_and_grads
    runs = [leaf_paths(loss_and_grads(params, cfg, batch,
                                      backend="cuda_decode")[2])
            for _ in range(2)]
    differ = [(path, float((a - b).abs().max()))
              for (path, a), (_, b) in zip(*runs) if not torch.equal(a, b)]
    args, kw = backward_call
    k2 = [msgs_decode._backward(*args, **kw) for _ in range(2)]
    k2_differ = [i for i, (a, b) in enumerate(zip(*k2))
                 if a is not None and not torch.equal(a, b)]
    return {"step_grads_bitwise_equal": not differ, "leaves": len(runs[0]),
            "differing_leaves": len(differ),
            "max_abs_diff": max((d for _, d in differ), default=0.0),
            "differing_leaf_paths": [p for p, _ in differ[:12]],
            "k2_backward_bitwise_equal": not k2_differ,
            "k2_backward_differing_outputs": [
                ("d_vp", "d_x", "d_y", "d_probs", "d_scale")[i] for i in k2_differ]}


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
    rerun = bitwise_rerun(params0, cfg, batch, rec_b.calls[0])

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
         max_one_ulp_spread=max(r["one_ulp_spread"] for r in per_leaf),
         rerun=rerun)
    return {"cfg": cfg, "params": params, "opt": opt, "opt_cfg": opt_cfg,
            "batch": batch, "launches": launches, "steps": TRAIN_STEPS,
            "backward_calls": rec_b.calls}


# --------------------------------------------------------------------------
# phase 4b: serve the full-width dense LM
# --------------------------------------------------------------------------

def lm_config():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def seeded_prompts(vocab):
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LM_PROMPTS]


class PlainAttention:
    """Inside the block, the decoder's decode attention takes K5's plain
    version on the card (``ops.flash_decode`` swapped in this process
    only)."""

    def __enter__(self):
        from repro_torch.kernels import flash_decode, ops
        self.orig = ops.flash_decode
        ops.flash_decode = lambda q, k, v, valid, *, chunk=512: \
            flash_decode.flash_decode_plain(q, k, v, valid, chunk=chunk)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_decode = self.orig


def lm_serve_run(cfg, params, prompts, device):
    """One ServeEngine run of the prompts: (engine, requests, decode steps,
    wall seconds). Each decode step records its K5 launches and whether
    its logits are finite."""
    import torch
    from repro_torch.kernels import flash_decode
    from repro_torch.serve.lm import Request, ServeConfig, ServeEngine
    engine = ServeEngine(cfg, params, ServeConfig(max_batch=LM_MAX_BATCH,
                                                  cache_len=LM_CACHE_LEN),
                         device=device)
    inner, steps = engine.api.decode_step, []

    def decode_step(*args, **kwargs):
        before = flash_decode.LAUNCHES
        logits, cache = inner(*args, **kwargs)
        steps.append({"flash_decode": flash_decode.LAUNCHES - before,
                      "finite": bool(torch.isfinite(logits).all())})
        return logits, cache
    engine.api = engine.api._replace(decode_step=decode_step)
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    engine.run_until_drained()
    torch.cuda.synchronize()
    return engine, reqs, steps, time.perf_counter() - t0


def phase_lm_serve(device):
    """Full-width minitron-4b (bf16, random seeded weights drawn on the
    card) served through ServeEngine: 4 requests, K5 in every decode
    layer; the decode-step logits against the plain attention."""
    import torch
    from repro_torch.kernels import flash_decode, matmul
    from repro_torch.models.decoder import decode_step, init_decoder

    cfg = lm_config()
    torch.cuda.reset_peak_memory_stats()
    params = init_decoder(cfg, torch.Generator(device=device).manual_seed(SEED),
                          device=device)
    param_bytes = sum(t.numel() * t.element_size() for _, t in leaf_paths(params))
    prompts = seeded_prompts(cfg.vocab_size)
    with Recorder(flash_decode, "flash_decode", 1) as rec:
        flash_decode.LAUNCHES = 0
        matmul.LAUNCHES = 0
        engine, reqs, steps, wall = lm_serve_run(cfg, params, prompts, device)
        launches = {"flash_decode": flash_decode.LAUNCHES,
                    "matmul": matmul.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    n_layers, n_steps = cfg.n_layers, len(steps)
    if n_steps != LM_NEW_TOKENS - 1 \
            or any(s["flash_decode"] != n_layers for s in steps) \
            or launches != {"flash_decode": n_layers * n_steps, "matmul": 0}:
        raise AssertionError(f"launch counts {launches} over {n_steps} decode "
                             f"steps {steps}; expected {n_layers} flash_decode "
                             "launches per step and no matmul")
    for r in reqs:
        if not (r.done and len(r.output) == LM_NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"request {r.rid}: done={r.done} "
                                 f"output={r.output}")
    if not all(s["finite"] for s in steps):
        raise AssertionError(f"non-finite decode logits: {steps}")

    # the next decode step from the served cache, through K5 and through
    # the plain attention (each writes the same slots before reading them)
    tokens, pos = engine.last_tok.clone(), engine.pos.clone()
    with torch.inference_mode():
        got, _ = decode_step(engine.params, cfg, engine.cache, tokens, pos)
        with PlainAttention():
            want, _ = decode_step(engine.params, cfg, engine.cache, tokens, pos)
    torch.cuda.synchronize()
    # bf16 tolerance: the two attentions round their outputs to bf16 at a
    # float32-ulp distance, so an output may move one bf16 step, and 32
    # layers carry that on: max |d logit| <= 16 bf16 steps (2^-4) and the
    # median <= one step (2^-8) of the largest |logit|
    err = (got - want).abs()
    scale = float(want.abs().max())
    logit_cmp = {"max_abs": float(err.max()), "median_abs": float(err.median()),
                 "max_logit": scale, "tol_max": 2 ** -4 * scale,
                 "tol_median": 2 ** -8 * scale}
    if not (torch.isfinite(got).all() and logit_cmp["max_abs"] <= logit_cmp["tol_max"]
            and logit_cmp["median_abs"] <= logit_cmp["tol_median"]):
        raise AssertionError(f"decode logits, K5 vs plain attention: {logit_cmp}")
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decided = gap > 2 * logit_cmp["tol_max"]
    agree = got.argmax(-1) == want.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError(f"greedy token differs where the top-2 gap "
                             f"{gap.tolist()} exceeds twice the tolerance")
    # the whole run again through the plain attention: how often do the
    # greedy streams agree (random heads have small top-2 gaps)
    with PlainAttention():
        _, plain_reqs, _, plain_wall = lm_serve_run(cfg, params, prompts, device)
    same = [sum(a == b for a, b in zip(r.output, p.output))
            for r, p in zip(reqs, plain_reqs)]
    first_diff = [next((i for i, (a, b) in enumerate(zip(r.output, p.output))
                        if a != b), None) for r, p in zip(reqs, plain_reqs)]
    cache_bytes = sum(t.numel() * t.element_size() for t in engine.cache.values())
    emit("lm_serve", model=cfg.name, dtype=str(cfg.dtype),
         params=cfg.param_count(), param_bytes=param_bytes,
         cache_bytes=cache_bytes, max_batch=LM_MAX_BATCH,
         cache_len=LM_CACHE_LEN, prompts=list(LM_PROMPTS),
         new_tokens=LM_NEW_TOKENS, decode_steps=n_steps, wall_s=wall,
         plain_attention_wall_s=plain_wall, launches=launches,
         launches_per_decode_step={k: v // n_steps for k, v in launches.items()},
         max_memory_allocated=peak, outputs=[r.output for r in reqs],
         decode_logits_vs_plain=logit_cmp, top2_gap=gap.tolist(),
         greedy_agree=agree.tolist(), greedy_decided=decided.tolist(),
         stream_tokens_agree=same, stream_first_difference=first_diff)
    args, kw = rec.calls[0]
    return {"cfg": cfg, "params": engine.params, "cache": engine.cache,
            "tokens": tokens, "pos": pos, "launches": launches,
            "steps": n_steps, "param_bytes": param_bytes,
            "k5_call": ([t.clone() for t in args], kw), "prompts": prompts}


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


def kernel_device_split(fn, kernel_names, calls=20):
    """Device time per call of ``fn`` in each kernel whose name contains
    one of ``kernel_names`` (a name or a tuple of names: every kernel one
    wrapper call launches), keyed by that name; profiler, CUPTI. Empty
    when the profiler records no device time on this machine."""
    names = (kernel_names,) if isinstance(kernel_names, str) else kernel_names
    dev, _, _ = profile(fn, calls)
    split = {}
    for e in dev:
        for n in names:
            if n in e.key and _device_us(e) > 0:
                split[n] = split.get(n, 0.0) + _device_us(e) / calls / 1e3
    return split


def kernel_device_ms(fn, kernel_names, calls=20):
    """The sum of ``kernel_device_split``; None without device time."""
    split = kernel_device_split(fn, kernel_names, calls)
    return sum(split.values()) if split else None


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


def gather_bytes(pts, row_bytes):
    """Corner-row bytes K1 or K3 gathers from L2: every in-level corner of
    every live point loads its row, rounded up to whole 32 B sectors
    (rows start at multiples of their size). For K3 this counts the
    corners before its windows drop any."""
    from repro_torch.msda.sampling import corner_data
    x, y, st, wl, hl, p = pts
    _, _, valid = corner_data(x, y, wl, hl, st)
    loads = int((valid & (p > 0)[..., None]).sum())
    return loads * SECTOR_BYTES * math.ceil(row_bytes / SECTOR_BYTES)


def l2_gather(pts, row_bytes, ms):
    nbytes = gather_bytes(pts, row_bytes)
    return {"l2_gather_bytes": nbytes,
            "l2_gather_tb_per_s": None if not ms else nbytes / ms / 1e9}


def kernel_times(call, plain, kernel_names):
    """``ms``: the kernel's own time on the card (profiler device time per
    call, summed over ``kernel_names``; CUDA events over back-to-back calls where the profiler sees no
    device time). ``call_ms``: CUDA events per wrapper call, host checks
    and launch included. ``plain_ms``: the plain version, CUDA events."""
    call_ms = cuda_ms(call, 11, 20)
    split = kernel_device_split(call, kernel_names)
    return {"ms": sum(split.values()) if split else call_ms,
            "ms_source": "profiler" if split else "cuda_events",
            "by_kernel": split, "call_ms": call_ms, "plain_ms": cuda_ms(plain, 5, 1)}


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


def peak_flop_per_s(dtype):
    """The card's dense rate for an input dtype: bf16 on the tensor
    cores, float32 (and int8 codes dequantized to float32) outside them."""
    import torch
    return BF16_FLOP_PER_S if dtype == torch.bfloat16 else F32_FLOP_PER_S


def roofline(nbytes, ops, dtype):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak_flop_per_s(dtype)
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def nbytes_of(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def flash_decode_bound(q, k, v, valid, out):
    """Least time for K5's function on these inputs: q, the mask and the
    output once, and the K and V rows of the valid slots (a row with no
    valid slot needs all its V rows and no K); 4 operations per channel,
    query head and needed slot (the score's multiply-add and P.V's)."""
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    n_valid = valid.sum(1)
    empty = n_valid == 0
    k_rows = int(n_valid.sum())
    v_rows = k_rows + int(empty.sum()) * w
    row = hkv * dh * k.element_size()
    nbytes = nbytes_of(q, valid, out) + (k_rows + v_rows) * row
    ops = 4 * dh * hq * (k_rows + int(empty.sum()) * w)
    return dict(roofline(nbytes, ops, q.dtype), valid_slots=k_rows,
                slots=b * w)


def matmul_bound(x, w, scale, out):
    """Least time for K4: x, w (and the scale) read once, the output
    written once, 2 M N K operations at x's rate."""
    m, k = x.shape
    return roofline(nbytes_of(x, w, scale, out), 2 * m * k * w.shape[1],
                    x.dtype)


def sdpa_call(q, k, v, valid):
    """The library's one call for K5's function (GQA and a boolean mask);
    used only as a yardstick."""
    import torch.nn.functional as F
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)


K5_KERNELS = ("flash_decode_split_kernel", "flash_decode_mma_kernel",
              "flash_decode_merge_kernel")
#: the kernels one K4 call launches, by route
K4_KERNELS = {"wgmma": ("matmul_wgmma_kernel", "matmul_splitk_reduce_kernel"),
              "simt": ("matmul_kernel",)}


def k5_entry(args, kw, launches):
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.msgs_fused import sm_count
    call = lambda: flash_decode.flash_decode(*args, **kw)
    plain = lambda: flash_decode.flash_decode_plain(*args, **kw)
    out = call()
    err = check_close("flash_decode timing operands", out, plain(),
                      tolerance(args[0].dtype, None))
    entry = {"name": "flash_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_decode.py:69",
             "launches": launches, "max_abs_err": err,
             **kernel_times(call, plain, K5_KERNELS),
             "library_ms": cuda_ms(sdpa_call(*args), 11, 20)}
    bound = flash_decode_bound(*args, out)
    entry.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    q, k = args[0], args[1]
    length, n_splits = flash_decode.decode_splits(
        q.shape[0], k.shape[2], flash_decode.head_groups(q.shape[1], k.shape[2]),
        k.shape[1], sm_count(q.device))
    return entry, dict(bound, shape=[list(t.shape) for t in args],
                       dtype=str(args[0].dtype), kernels=list(K5_KERNELS),
                       split_len=length, splits=n_splits)


def k4_entry(x, w, scale, launches, library=True):
    import torch
    from repro_torch.kernels import matmul
    from repro_torch.kernels.msgs_fused import sm_count
    call = lambda: matmul.matmul(x, w, scale)
    plain = lambda: matmul.matmul_plain(x, w, scale)
    route = matmul.matmul_route(x, w, scale)
    out = call()
    err = check_close("matmul timing operands", out, plain(),
                      matmul_tolerance(x, w, scale))
    entry = {"name": "matmul", "route": "cuda",
             "source": "src/repro_torch/csrc/matmul.cu",
             "replaces": "src/repro/kernels/matmul.py:44",
             "launches": launches, "max_abs_err": err,
             **kernel_times(call, plain, K4_KERNELS[route]),
             "library_ms": cuda_ms(lambda: torch.matmul(x, w), 11, 20)
             if library else None}
    bound = matmul_bound(x, w, scale, out)
    entry.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    m, k = x.shape
    return entry, dict(bound, shape=[list(x.shape), list(w.shape)],
                       x=str(x.dtype), w=str(w.dtype), k4_route=route,
                       kernels=list(K4_KERNELS[route]),
                       splits=matmul.matmul_splits(m, w.shape[1], k,
                                                   sm_count(x.device))
                       if route == "wgmma" else None)


def lm_step_ms(fn, reps=5):
    """Median host time of ``fn`` ending in a synchronize, after a
    warm-up; and its peak device memory."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts), torch.cuda.max_memory_allocated()


def lm_times(lm):
    """K5 on the served path's first decode call (and its operands in
    float32) and on a full cache in bf16 and float32, K4 on minitron-4b's
    MLP-up products (prefill and decode, bf16 and int8 + scale, prefill in
    float32), one decode step at B = 4 and one 512-token prefill."""
    import torch
    from repro_torch.models.decoder import decode_step, init_cache, prefill
    cfg, params, dev = lm["cfg"], lm["params"], lm["tokens"].device
    k5, d5 = k5_entry(*lm["k5_call"], lm["launches"]["flash_decode"])
    gen = torch.Generator().manual_seed(SEED + 4)
    keep = ("ms", "ms_source", "by_kernel", "call_ms", "plain_ms", "library_ms",
            "max_abs_err")
    for label, dtype in (("full_cache", cfg.dtype), ("full_cache_f32", torch.float32),
                         ("served_f32", torch.float32)):
        if label == "served_f32":
            args, kw = lm["k5_call"]
            ops = [t.float() if t.is_floating_point() else t for t in args]
        else:
            ops, kw = k5_operands(gen, LM_MAX_BATCH, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.dh, LM_CACHE_LEN, dtype, "full", dev), {"chunk": 512}
        e, bd = k5_entry(ops, kw, 0)
        d5[label] = {k: e[k] for k in keep} | bd

    # K4 on layer 0's real w_up: the prefill product (2048 tokens) is the
    # summary's row, in bf16 like the model
    w_up = params["layers"]["mlp"]["w_up"][0].contiguous()
    x = torch.randn((2048, cfg.d_model), generator=gen).to(cfg.dtype).to(dev)
    k4, d4 = k4_entry(x, w_up, None, lm["launches"]["matmul"])
    d4["other_operands"] = {}
    for label, xx, ww, sc, lib in (
            ("decode_mlp_up_b4_bf16", x[:LM_MAX_BATCH].contiguous(), w_up, None, True),
            ("prefill_mlp_up_f32", x.float(), w_up.float(), None, True),
            ("prefill_mlp_up_int8", *k4_operands(gen, 2048, cfg.d_model,
                                                 cfg.d_ff, "int8", dev), False),
            ("decode_mlp_up_b4_int8", *k4_operands(gen, LM_MAX_BATCH, cfg.d_model,
                                                   cfg.d_ff, "int8_bf16x", dev),
             False)):
        e, bd = k4_entry(xx, ww, sc, 0, library=lib)
        d4["other_operands"][label] = {k: e[k] for k in keep} | bd

    # one decode step at B = 4 from the served cache (it rewrites the
    # same slots every time), and one 512-token prefill into a fresh cache
    def step():
        with torch.inference_mode():
            decode_step(params, cfg, lm["cache"], lm["tokens"], lm["pos"])
    step_ms, step_peak = lm_step_ms(step)
    prompt = torch.as_tensor(lm["prompts"][-1], device=dev)[None]

    def fill():
        with torch.inference_mode():
            prefill(params, cfg, init_cache(cfg, 1, LM_CACHE_LEN, device=dev),
                    prompt)
    fill_ms, fill_peak = lm_step_ms(fill, reps=3)
    valid_rows = sum(int(((lm["cache"]["kpos"][i] <= lm["pos"][:, None])).sum())
                     for i in range(cfg.n_layers))
    weights = lm["param_bytes"] - nbytes_of(params["embed"]) \
        + LM_MAX_BATCH * cfg.d_model * params["embed"].element_size()
    kv = 2 * valid_rows * cfg.n_kv_heads * cfg.dh * params["embed"].element_size()
    timing = {
        "decode_step_ms_b4": step_ms, "decode_step_peak_bytes": step_peak,
        "decode_step_profile": forward_profile(step),
        "decode_step_bound": roofline(weights + kv, 0, cfg.dtype)
        | {"weight_bytes": weights, "valid_kv_bytes": kv},
        "prefill_512_ms": fill_ms, "prefill_512_peak_bytes": fill_peak,
        "prefill_512_profile": forward_profile(fill)}
    return [k4, k5], {"matmul": d4, "flash_decode": d5}, timing


def phase_times(serve, serve_w, train, lm):
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
                                 table=list(v.shape), dtype=str(v.dtype),
                                 **l2_gather(pts, v.shape[3] * v.element_size(),
                                             k1["ms"]))}

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
        **l2_gather((pts[0], pts[1], st, wl, hl, pts[3]),
                    v.shape[3] * v.element_size(), k3["ms"]),
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

    lm_kernels, lm_detail, lm_timing = lm_times(lm)
    kernels += lm_kernels
    detail.update(lm_detail)

    step_ms, step = train_step_ms(train)
    times = {"train_step_ms_b2": step_ms,
             "serve_forward_ms_b2": forward_ms(serve, "auto"),
             "torch_gather_forward_ms_b2": forward_ms(serve, "torch_gather"),
             "serve_1024_forward_ms_b2": forward_ms(serve_w, "cuda_windowed"),
             "torch_gather_1024_forward_ms_b2": forward_ms(
                 serve_w, "torch_gather", reps=3)}
    for k in kernels:
        detail[k["name"]].update(ms_source=k.pop("ms_source"),
                                 call_ms=k.pop("call_ms"), by_kernel=k.pop("by_kernel"))
    batches = {"msgs_fused": serve["batches"], "msgs_decode": serve["batches"],
               "msgs_windowed": serve_w["batches"],
               "msgs_decode_backward": train["steps"],
               "flash_decode": lm["steps"], "matmul": lm["steps"]}
    emit("times", kernels=detail,
         library_note={"msgs_*": LIBRARY_NOTE,
                       "flash_decode": "F.scaled_dot_product_attention with "
                                       "enable_gqa=True and the boolean mask",
                       "matmul": "torch.matmul (bf16)"},
         **times, forward_profile=serve_profile(serve, "auto"),
         forward_profile_1024=serve_profile(serve_w, "cuda_windowed"),
         train_step_profile=forward_profile(step),
         train_launches_per_step={k: v // train["steps"]
                                  for k, v in train["launches"].items()},
         launches_per_forward={k["name"]: k["launches"] // batches[k["name"]]
                               for k in kernels},
         lm=lm_timing,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                "f32_flop_per_s": F32_FLOP_PER_S,
                "bf16_flop_per_s": BF16_FLOP_PER_S})
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
    phase_lm_kernels(device)
    serve = phase_serve(device)
    serve_w = phase_serve_windowed(device)
    train = phase_train(device)
    lm = phase_lm_serve(device)
    kernels = phase_times(serve, serve_w, train, lm)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
