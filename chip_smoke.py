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
                12/16/32/64 (Dh 12: rows of 48, 24 and 12 B, which the
                gather plan serves with 16, 8 and 4 B vectors); K2 also
                with Dh 12 in head groups of 4 and on a staged table one
                element off its 16 B boundary;
     windowed — K3 against its plain version: the same tables x {dense,
                compact with keep_idx} at the 1024 px path's shape and on a
                ragged small pyramid (Dh 16 and 64, head_pack 1; Dh 12,
                head_pack 2), with points up to three range bounds from
                their reference, so that the windows drop corners;
     decode_grad — K2's backward kernels against their closed-form plain
                version: the same tables x {dense, compact} x head_pack
                {1, 4} x L {1, 3} at the 512 px decoder's shape and a
                ragged small one, with points on integer coordinates and
                outside their level, each case called twice and held to
                bitwise-equal outputs; K2's output carries a grad_fn under
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
                weights, float32) with backend="auto": the engine warms the
                bucket up and captures its forward in one CUDA graph at
                construction, then serves 4 requests by replays; launch
                counters (the wrappers run at the warm-up and the capture
                only), compile_count 1 before and after, the engine's JSONL
                log (REPRO_OBS_JSONL in a temporary directory) through
                ``python -m repro_torch.obs.validate --require
                msda_compiles_total serve_requests_total``, and the same
                forward through torch_gather;
     serve_1024 — the same detector at the 1024 px bucket with an int8
                value table and backend="cuda_windowed" (K3 in the
                encoder, K2 in the decoder), captured the same way: 4
                requests, launch counters, and the same forward through
                torch_gather and cuda_fused;
     train    — the full-width deformable-DETR-DEFA detector (512 px,
                float32, decoder head) trained for 3 AdamW steps at B = 2
                on one seeded synthetic batch with backend="cuda_decode"
                (K2 forward and backward in the decoder, torch_gather in
                the encoder): launch counters, finite and falling losses,
                live decoder gradients, the first step's gradients
                against the same step through torch_gather, and whether
                two identical gradient passes agree bitwise (required of
                one K2 backward call repeated; recorded for the whole
                step, whose torch_gather encoder adds with index_add_);
     lm_serve — minitron-4b at its published width and depth (bf16,
                random weights drawn on the card from the seed) served by
                ServeEngine (max_batch 4, cache_len 4096), whose decode
                step is one CUDA graph captured at construction: 4 prompts
                of 37, 128, 300 and 512 tokens, 16 greedy tokens each;
                launch counters (K5 at the warm-up step and the capture
                only, no K4), tokens in range, finite logits, peak memory,
                the next decode step replayed against the eager step and
                through K5 against the plain attention, and how often the
                greedy streams agree with an eager run and with a
                plain-attention run;
     capture  — what the graphs do, for the 512 px bucket (and the same
                detector without the DEFA knobs), the 1024 px int8 bucket
                and the LM decode step: the replay against the eager
                forward on the same inputs (DEFA's limits; 1e-4 without
                the knobs; lm_serve's logit limits) and whether they are
                bitwise equal; per replay from torch.profiler: K1 6 and K2
                6 (512 px), K3 6 and K2 6 (1024 px), K5 32 split and 32
                merge kernels (decode step), one cudaGraphLaunch, no
                pageable host-to-device copy (the images come from pinned
                staging buffers); eager against captured wall clock (median, p10,
                p90 over 50 steps), device busy ms and idle share, peak
                allocated bytes, and the memory the engine holds after
                construction (its graphs' pool); one engine with both the
                512 and the 1024 px buckets serving both sizes and two
                pad-ups with compile_count 2 throughout;
     stream   — StreamingDetrEngine on the same detector's decoder and
                heads (full width, 512 px levels, backend cuda_decode): 2
                video sessions x 8 drifting-scene frames of encoder
                memories, float32 then int8 table at the config's INT12:
                per-frame mode and staged against rebuild bytes, wrapper
                launches (6 K2 per frame, nothing else), K2 per frame from
                torch.profiler, wall clock per frame by mode (median, p10,
                p90), device busy and idle share, peak memory, outputs
                against decoder_apply on a cache built from scratch under
                the same FWP state (DEFA's limits; 1e-5 with act_bits None),
                int8 codes that differ from a fresh build; the staged table
                against a fresh staging and K2 on it against K2 on that
                staging (bitwise) and against its plain version;
                delta_threshold 0 (float32: table, staged table and
                outputs bitwise a rebuild's; int8: reported);
                reorder_sessions from a layout it moves against an engine
                that does not reorder (next detections bitwise); the 512 px
                bucket with query_order "zorder" against "none" (bitwise,
                eager and captured); the stream log through the validator;
     autotune — the port's plan autotuner (``repro_torch.msda.autotune``)
                on the card into a temporary table: the L2 knee (K1 over
                tables from L2/8 to 4 x L2), K2's once-staged sweep
                against K1 per layer at the 512 px decoder's shape, and
                the stream crossover; measured provenance, the tuned
                ``auto`` picks bitwise the same backends planned
                statically (512 px, encoder and decoder), each served
                bucket's static and measured ``auto`` pick, the 512 px
                decoder's measured tile windows (unordered and zorder);
                results/autotune_torch.json is left unchanged;
  5. times    — each kernel and its plain version on the operands its
                path gave it, their bounds and the library call where one
                exists (K2's backward: the whole call, every kernel it
                launches; K2 also on the 1024 px path's first decoder
                call and on the stream path's int8 staged table), K1's and
                K3's L2 gather bytes, K1 on K3's and on
                K2's operands, the device time of one train step's
                table-gradient chain, one serve forward at B = 2 per path,
                one train step, one LM decode step at B = 4 and one
                512-token prefill, each with its idle share.

    python3 chip_smoke.py --table-grad-chain SRC

times only the table-gradient chain of the train step's first backward
pass, with the port package under ``SRC`` (for example an unpacked
parent commit's ``src``), and prints it as one JSON line.

Then the kernel summary line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result.
"""
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
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
# of every point, and p w_c g (multiply) plus its add into the row's sum
# for every valid corner of a live point.
FLOPS_PER_CHANNEL_CORNER_DOT = 2
FLOPS_PER_CHANNEL_CORNER_SCATTER = 2
# every kernel a K2 backward call launches: the points kernel, then the
# table kernel (float tables) or the scale kernel (int8 tables)
K2_BWD_KERNELS = ("msgs_decode_bwd_points_kernel", "msgs_decode_bwd_table_kernel",
                  "msgs_decode_bwd_scale_kernel")
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
CAPTURE_STEPS = 50               # wall-clock samples per path, eager and captured
STREAM_SESSIONS = 2              # video sessions of the streaming engine
STREAM_FRAMES = 8                # drifting-scene frames per session
STREAM_SEED = 17
STREAM_METRICS = ("stream_frames_total", "staged_bytes_total",
                  "stream_span_seconds", "stream_frame_latency_seconds",
                  "msda_traces_total")
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
    import dataclasses
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
    # K2 alone: Dh 12 in head groups of 4, and a staged table one element
    # off its 16 B boundary (both narrow the gather plan's vector)
    for label, dh, g, offset in (("decode_dh12_g4", 12, 4, 0),
                                 ("decode_misaligned_g4", 32, 4, 1)):
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            for compact in (False, True):
                pts, n_pix = synthetic_points(gen, (2, 3, 19, 8, 4),
                                              small_levels, device)
                n_rows = 300 if compact else n_pix
                v, remap, scale = synthetic_table(gen, 2, n_rows, 8, dh, dtype,
                                                  compact, n_pix, device)
                staged = msgs_decode.stage_decode_table(v, remap, head_pack=g,
                                                        scale=scale)
                if offset:
                    buf = torch.empty(staged.v.numel() + offset,
                                      dtype=dtype, device=device)
                    shifted = buf[offset:].view(staged.v.shape)
                    shifted.copy_(staged.v)
                    staged = dataclasses.replace(staged, v=shifted)
                case = f"{label}/{str(dtype)[6:]}/{'compact' if compact else 'dense'}"
                want = msgs_decode.msgs_decode_plain(
                    staged.v, *pts, staged.remap, staged.scale, head_pack=g,
                    dh=dh)
                err = check_close(f"msgs_decode_layers {case}",
                                  msgs_decode.msgs_decode_layers(staged, *pts),
                                  want, tolerance(dtype, scale))
                results.append({"case": case, "decode_layers_err": err})
    emit("kernels", checks=sum(k.endswith("_err") for r in results for k in r),
         results=results,
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
    """K2 backward vs plain. d_vp and d_scale: the kernels sum them in a
    fixed order that is not the plain version's, so rtol 1e-5 (2^-7 for
    a bf16 d_vp, rounded once from float32 on both sides) and atol 1e-5
    of the largest entry. The point gradients: each a sum over one
    point's corners in the same order on both sides: float32 1e-5, int8
    1e-5 * 127 * max scale."""
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


def check_bitwise(case, first, again):
    """Two K2 backward calls on the same operands: every output bit for
    bit the same."""
    import torch
    torch.cuda.synchronize()
    for name, a, b in zip(GRAD_NAMES, first, again):
        if (a is None) != (b is None) or (a is not None and not torch.equal(a, b)):
            raise AssertionError(f"msgs_decode_backward {case}: {name} differs "
                                 "between two calls on the same operands")


def phase_decode_grad(device, main_levels):
    """K2's backward kernels against msgs_decode_backward_plain, each case
    twice and bitwise equal, and the autograd contract of the three
    kernels on the card."""
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
                        check_bitwise(case, got, msgs_decode.msgs_decode_backward(
                            staged, *pts, g_out))
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
         repeats_bitwise_equal=len(results),
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


@contextlib.contextmanager
def obs_log_env():
    """``REPRO_OBS_JSONL`` pointed at a fresh file in a temporary directory
    for the block: an engine built with ``obs=None`` logs its events
    there. Yields the path."""
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "serve.jsonl")
        old = os.environ.get("REPRO_OBS_JSONL")
        os.environ["REPRO_OBS_JSONL"] = path
        try:
            yield path
        finally:
            if old is None:
                os.environ.pop("REPRO_OBS_JSONL", None)
            else:
                os.environ["REPRO_OBS_JSONL"] = old


def validate_log(path, require=("msda_compiles_total",
                                "serve_requests_total")):
    """The engine's JSONL log through ``python -m repro_torch.obs.validate
    --require <require>`` (a process of its own), and the log's event
    counts."""
    import repro_torch
    src = str(Path(repro_torch.__file__).resolve().parents[1])
    cmd = [sys.executable, "-m", "repro_torch.obs.validate", "--jsonl", path,
           "--require", *require]
    run = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    if run.returncode != 0:
        raise AssertionError(f"obs validator rc {run.returncode}: "
                             f"{run.stdout} {run.stderr}")
    types = [json.loads(line)["type"] for line in open(path) if line.strip()]
    return {"validator_rc": run.returncode, "validator": run.stdout.strip(),
            "events": len(types),
            "by_type": {t: types.count(t) for t in sorted(set(types))}}


def wall_stats(fn, n=CAPTURE_STEPS):
    """Host-clock ms of ``fn`` ending in a synchronize: ``n`` samples after
    a warm-up; median, p10 and p90."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    dec = statistics.quantiles(ts, n=10)
    return {"n": n, "median_ms": statistics.median(ts), "p10_ms": dec[0],
            "p90_ms": dec[-1]}


def replay_counts(fn, kernel_names):
    """One call of ``fn`` under the profiler (after a warm-up): device
    launches of each kernel whose name contains one of ``kernel_names``,
    the host's ``cudaGraphLaunch`` and ``cudaLaunchKernel`` calls, and
    the host-to-device copies by host memory kind."""
    dev, cpu, _ = profile(fn)
    count = lambda evts, frag: sum(e.count for e in evts if frag in e.key)
    return {"kernels": {n: count(dev, n) for n in kernel_names},
            "device_kernels": sum(e.count for e in dev),
            "cudaGraphLaunch": count(cpu, "cudaGraphLaunch"),
            "cudaLaunchKernel": count(cpu, "cudaLaunchKernel"),
            "htod_pageable": count(dev, "Memcpy HtoD (Pageable"),
            "htod_pinned": count(dev, "Memcpy HtoD (Pinned")}


def check_replay(label, counts, want_kernels, want_pinned):
    """One replay: each kernel of the path launched as often as in one
    forward, one graph launch, no pageable host-to-device copy and at
    most ``want_pinned`` pinned ones (the profiler has been seen to miss
    the record of that one copy in some runs; ``detector_capture`` checks
    that the staging buffers are pinned)."""
    bad = {k: (counts["kernels"][k], n) for k, n in want_kernels.items()
           if counts["kernels"][k] != n}
    if bad or counts["cudaGraphLaunch"] != 1 or counts["htod_pageable"] \
            or counts["htod_pinned"] > want_pinned:
        raise AssertionError(f"{label}: one replay {counts}; expected kernels "
                             f"{want_kernels}, 1 cudaGraphLaunch, 0 pageable "
                             f"and at most {want_pinned} pinned HtoD copies")


def step_timing(fns):
    """For each labelled step function: wall-clock median, p10 and p90
    over CAPTURE_STEPS steps; device busy ms and idle share of one
    profiled step (the profiler slows the host, so that idle share is an
    upper bound), and 1 - busy / median; the peak allocated bytes over
    the steps (a graph's pool is reserved, not allocated, during a
    replay: ``engine_memory`` counts it)."""
    import torch
    out = {}
    for label, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = wall_stats(fn)
        rec["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        prof = forward_profile(fn)
        busy = prof["device_busy_ms"]
        rec.update(device_busy_ms=busy, idle_share=prof["idle_share"],
                   profiled_wall_ms=prof["wall_ms"],
                   idle_share_at_median=max(0.0, 1 - busy / rec["median_ms"]),
                   device_kernels=prof["n_kernels"])
        out[label] = rec
    return out


def memory_mark():
    """Garbage collected, cached blocks released and the peak reset: the
    (reserved, allocated) bytes before an engine is built."""
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def engine_memory(before):
    """Peak allocated bytes over an engine's construction (warm-up and
    capture); the live bytes it added (static buffers, the graphs' outputs,
    cached constants and, for the LM, its KV cache); the reserved bytes
    it added with the cached blocks released (it undercounts where the
    engine reused blocks that could not be released); and the bytes of
    the segments in CUDA-graph private pools, the graphs' own memory (only
    the engine just built holds graphs at that point)."""
    import torch
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pools = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))
    return {"construct_peak_allocated_bytes": peak,
            "allocated_growth_bytes": torch.cuda.memory_allocated() - before[1],
            "held_bytes": torch.cuda.memory_reserved() - before[0],
            "graph_pool_bytes": pools}


def detector_capture(engine, res, images, kernels, defa, timing=True):
    """The bucket's captured forward against the engine's eager forward
    on the same B = 2 images: agreement (held to DEFA's limits, or to
    1e-4 without the DEFA knobs) and whether they are bitwise equal; one
    replay's kernel launches, graph launches and copies; and, with
    ``timing``, eager against captured wall clock, device busy and idle
    share. Eager takes the images from host memory as the eager engine
    did (a pageable copy)."""
    import numpy as np
    import torch
    batch = images[:MAX_BATCH]

    def captured():
        cls_logits, boxes, ready = engine.dispatch(batch, res)
        ready.synchronize()
        return cls_logits, boxes

    def eager():
        x = torch.from_numpy(np.stack(batch)).to(engine.device)
        return engine.forward(x, res)[:2]
    got, want = captured(), eager()
    torch.cuda.synchronize()
    compare = {}
    if defa:
        defa_agreement("captured_vs_eager", got, want, compare)
    else:
        compare.update({f"captured_vs_eager/{k}": v
                        for k, v in abs_errors(got, want).items()})
        for i, name in enumerate(OUTPUTS):
            if not torch.allclose(got[i], want[i], rtol=1e-4, atol=1e-4):
                raise AssertionError(f"captured vs eager {name}: {compare}")
    rec = {"bucket": res, "agreement": compare,
           "bitwise_equal": all(torch.equal(a, b) for a, b in zip(got, want)),
           "replay": replay_counts(captured, tuple(kernels)),
           "staging_pinned": all(buf.is_pinned()
                                 for buf in engine._graphs[res].pinned)}
    check_replay(f"{res} px bucket", rec["replay"], kernels, want_pinned=1)
    if not rec["staging_pinned"]:
        raise AssertionError(f"{res} px bucket: staging buffers not pinned")
    if timing:
        rec["steps"] = step_timing({"eager": eager, "captured": captured})
    return rec


def phase_serve(device):
    """The 512 px bucket: the engine captures it at construction and
    serves 4 requests by replays (K1 and K2 inside); the replay against
    the eager forward, per-replay counts, wall clock, and the engine's
    telemetry log through the validator."""
    import numpy as np
    import torch
    from repro_torch.core.detector import detector_apply, init_detector
    from repro_torch.kernels import msgs_decode, msgs_fused
    from repro_torch.obs import Observability
    from repro_torch.serve import DetrServeEngine

    cfg = slice_config("deformable-detr-defa")
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    images = seeded_images(N_REQUESTS)
    n_blocks, n_layers = cfg.encoder.n_blocks, cfg.decoder.n_layers
    x = torch.from_numpy(np.stack(images[:MAX_BATCH])).to(device)
    with obs_log_env() as log:
        before = memory_mark()
        msgs_fused.LAUNCHES = 0
        msgs_decode.LAUNCHES = 0
        with DetrServeEngine(cfg, params, max_batch=MAX_BATCH, backend="auto",
                             device=device) as engine:
            memory = engine_memory(before)
            compiles = engine.compile_count
            plan = engine.buckets[0].plan
            reqs, wall = serve_requests(engine, images)
            launches = {"msgs_fused": msgs_fused.LAUNCHES,
                        "msgs_decode": msgs_decode.LAUNCHES}
            batches = engine.batches_dispatched
            capture = detector_capture(
                engine, IMG, images,
                {"msgs_fused_kernel": n_blocks, "msgs_decode_kernel": n_layers},
                defa=True)
            capture.update(memory=memory, compile_count=[
                compiles, engine.compile_count])
            # the eager forward of the first batch: the timing phase's
            # operands of each kernel
            with Recorder(msgs_fused, "msgs_fused", n_blocks) as rec_f, \
                    Recorder(msgs_decode, "msgs_decode", n_layers) as rec_d:
                engine.forward(x, IMG)
        obs = validate_log(log)
    check_requests(reqs)
    # every request was served by replays: the wrappers ran at the warm-up
    # forward and at the capture, once per block or layer each
    if batches != N_REQUESTS // MAX_BATCH or compiles != 1 \
            or capture["compile_count"] != [1, 1] \
            or launches != {"msgs_fused": 2 * n_blocks,
                            "msgs_decode": 2 * n_layers}:
        raise AssertionError(f"launch counts {launches} over {batches} batches, "
                             f"compile_count {capture['compile_count']}; "
                             f"expected {2 * n_blocks} fused and "
                             f"{2 * n_layers} decode launches (warm-up and "
                             "capture) and one preparation")

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
    # the same detector without the DEFA knobs, captured: within 1e-4 of
    # its eager forward
    with DetrServeEngine(plain_cfg, plain_params, max_batch=MAX_BATCH,
                         backend="auto", obs=Observability.disabled(),
                         device=device) as plain_engine:
        plain_capture = detector_capture(
            plain_engine, IMG, images,
            {"msgs_fused_kernel": n_blocks, "msgs_decode_kernel": n_layers},
            defa=False, timing=False)
    with torch.inference_mode():
        a = detector_apply(engine.params, cfg, x, backend="auto")
        g = detector_apply(engine.params, cfg, x, backend="torch_gather")
    defa_agreement("deformable-detr-defa", a, g, compare)
    emit("serve", model="deformable-detr-defa", img=IMG, n_in=plan.n_in,
         requests=N_REQUESTS, batches=batches, wall_s=round(wall, 4),
         plan=plan.describe(), launches=launches,
         launches_per_replay=capture["replay"]["kernels"],
         compile_count=capture["compile_count"], obs_log=obs,
         auto_vs_torch_gather=compare)
    return {"params": engine.params, "cfg": cfg, "x": x, "launches": launches,
            "batches": batches, "fused_calls": rec_f.calls,
            "decode_calls": rec_d.calls, "capture": capture,
            "plain_capture": plain_capture, "obs_log": obs}


def phase_serve_windowed(device):
    """The 1024 px bucket with an int8 value table through K3, captured."""
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
    n_blocks, n_layers = cfg.encoder.n_blocks, cfg.decoder.n_layers
    x = torch.from_numpy(np.stack(images[:MAX_BATCH])).to(device)
    before = memory_mark()
    msgs_windowed.LAUNCHES = 0
    msgs_decode.LAUNCHES = 0
    msgs_fused.LAUNCHES = 0
    with DetrServeEngine(cfg, params, max_batch=MAX_BATCH,
                         backend="cuda_windowed", resolutions=(IMG_WINDOWED,),
                         device=device) as engine:
        memory = engine_memory(before)
        compiles = engine.compile_count
        dec_plan = engine.buckets[0].plan
        reqs, wall = serve_requests(engine, images)
        launches = {"msgs_windowed": msgs_windowed.LAUNCHES,
                    "msgs_decode": msgs_decode.LAUNCHES,
                    "msgs_fused": msgs_fused.LAUNCHES}
        batches = engine.batches_dispatched
        capture = detector_capture(
            engine, IMG_WINDOWED, images,
            {"msgs_windowed_kernel": n_blocks, "msgs_decode_kernel": n_layers,
             "msgs_fused_kernel": 0}, defa=True)
        capture.update(memory=memory,
                       compile_count=[compiles, engine.compile_count])
        with Recorder(msgs_windowed, "msgs_windowed_msp", n_blocks) as rec_w, \
                Recorder(msgs_decode, "msgs_decode", 1) as rec_d:
            engine.forward(x, IMG_WINDOWED)
    check_requests(reqs)
    if batches != N_REQUESTS // MAX_BATCH or capture["compile_count"] != [1, 1] \
            or launches != {"msgs_windowed": 2 * n_blocks,
                             "msgs_decode": 2 * n_layers, "msgs_fused": 0}:
        raise AssertionError(f"launch counts {launches} over {batches} batches, "
                             f"compile_count {capture['compile_count']}; "
                             f"expected {2 * n_blocks} windowed, "
                             f"{2 * n_layers} decode and 0 fused launches "
                             "(warm-up and capture)")
    if enc_plan.backend != "cuda_windowed" or dec_plan.backend != "cuda_decode" \
            or enc_plan.table_dtype != "int8":
        raise AssertionError(f"plans {enc_plan.describe()} / "
                             f"{dec_plan.describe()}")

    # every block's K3 output of the eager forward against torch_gather on
    # the same operands, within the kernel tolerance
    blocks = [check_close(f"msgs_windowed block {i} vs torch_gather",
                          msgs_windowed.msgs_windowed_msp(*args, **kw),
                          gather_on_k3_operands(args, kw),
                          tolerance(args[0].dtype, kw.get("scale")))
              for i, (args, kw) in enumerate(rec_w.calls)]

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
         launches=launches, launches_per_replay=capture["replay"]["kernels"],
         compile_count=capture["compile_count"],
         blocks_vs_torch_gather_max_abs_err=blocks, windowed_vs=compare)
    return {"params": engine.params, "cfg": cfg, "x": x, "launches": launches,
            "batches": batches, "windowed_calls": rec_w.calls,
            "decode_calls": rec_d.calls, "capture": capture}


def serve_mixed(device):
    """One engine with the 512 and the 1024 px buckets (float32 table,
    ``auto``): requests of both sizes and two pad-ups; compile_count is
    the number of buckets after construction and after the load."""
    import torch
    from repro_torch.core.detector import init_detector
    from repro_torch.obs import Observability
    from repro_torch.serve import DetrRequest, DetrServeEngine

    cfg = slice_config("deformable-detr-defa")
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    small, large = seeded_images(2), seeded_images(2, IMG_WINDOWED)
    load = [small[0], large[0], small[1], large[1],
            large[0][:, :700, :900].copy(), small[0][:, :300, :400].copy()]
    want = [IMG, IMG_WINDOWED, IMG, IMG_WINDOWED, IMG_WINDOWED, IMG]
    with DetrServeEngine(cfg, params, max_batch=MAX_BATCH, backend="auto",
                         resolutions=(IMG, IMG_WINDOWED),
                         obs=Observability.create(), device=device) as engine:
        before = engine.compile_count
        reqs = [DetrRequest(rid=i, image=im) for i, im in enumerate(load)]
        for r in reqs:
            if not engine.submit(r):
                raise AssertionError(f"request {r.rid} rejected: {r.error}")
        engine.run_until_drained()
        torch.cuda.synchronize()
        m = engine.obs.metrics
        rec = {"buckets": [b.resolution for b in engine.buckets],
               "compile_count": [before, engine.compile_count],
               "compiles_by_bucket": {
                   str(b.resolution): m.value("msda_compiles_total",
                                              bucket=str(b.resolution))
                   for b in engine.buckets},
               "batches": engine.batches_dispatched,
               "completed": sum(
                   m.value("serve_requests_total", bucket=str(b.resolution),
                           outcome="completed") for b in engine.buckets),
               "latency_observations": m.get(
                   "serve_request_latency_seconds").total_count(),
               "routed": [r.bucket for r in reqs]}
    check_requests(reqs)
    if rec["compile_count"] != [2, 2] or rec["routed"] != want \
            or rec["completed"] != len(load) \
            or rec["latency_observations"] != len(load) \
            or set(rec["compiles_by_bucket"].values()) != {1.0}:
        raise AssertionError(f"mixed buckets: {rec}")
    return rec


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
    backward call twice on the same operands. K2's backward sums in a
    fixed order (csrc/msgs_decode_bwd.cu): phase_train requires its
    repeat to be bitwise equal. The encoder's torch_gather backward adds
    with index_add_, which may add in another order on every run, so the
    whole step's leaves are recorded, not required."""
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
    with Recorder(msgs_decode, "_backward", cfg.decoder.n_layers) as rec_b:
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
    if not rerun["k2_backward_bitwise_equal"]:
        raise AssertionError(f"K2 backward repeated on the same operands is "
                             f"not bitwise equal: {rerun}")

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


def lm_serve_run(cfg, params, prompts, device, eager=False,
                 serving=contextlib.nullcontext()):
    """One ServeEngine run of the prompts: (engine, requests, decode steps,
    wall seconds, the engine's memory after construction). The engine
    captures its decode step at construction; ``eager`` drops the graph
    before serving, so that every step runs ``decode_step`` eagerly (the
    yardstick of the captured steps). ``serving`` is entered around the
    run only, after construction's warm-up and capture. Each decode step
    records whether its logits are finite."""
    import torch
    from repro_torch.serve.lm import Request, ServeConfig, ServeEngine
    before = memory_mark()
    engine = ServeEngine(cfg, params, ServeConfig(max_batch=LM_MAX_BATCH,
                                                  cache_len=LM_CACHE_LEN),
                         device=device)
    memory = engine_memory(before)
    if eager:
        engine._graph = None
    inner, steps = engine.decode_logits, []

    def decode_logits():
        logits = inner()
        steps.append({"finite": bool(torch.isfinite(logits).all())})
        return logits
    engine.decode_logits = decode_logits
    reqs = [Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    t0 = time.perf_counter()
    with serving:
        engine.run_until_drained()
    torch.cuda.synchronize()
    engine.decode_logits = inner
    return engine, reqs, steps, time.perf_counter() - t0, memory


def stream_agreement(reqs, others):
    """Per request: how many greedy tokens two runs share, and the first
    position where they differ (None if nowhere)."""
    same = [sum(a == b for a, b in zip(r.output, p.output))
            for r, p in zip(reqs, others)]
    first = [next((i for i, (a, b) in enumerate(zip(r.output, p.output))
                   if a != b), None) for r, p in zip(reqs, others)]
    return same, first


def logit_limits(got, want):
    """bf16 tolerance of one decode step's logits against another's: the
    two round their attention outputs to bf16 at a float32-ulp distance,
    so an output may move one bf16 step, and 32 layers carry that on: max
    |d logit| <= 16 bf16 steps (2^-4) and the median <= one step (2^-8)
    of the largest |logit|."""
    import torch
    err = (got - want).abs()
    scale = float(want.abs().max())
    cmp = {"max_abs": float(err.max()), "median_abs": float(err.median()),
           "max_logit": scale, "tol_max": 2 ** -4 * scale,
           "tol_median": 2 ** -8 * scale,
           "bitwise_equal": bool(torch.equal(got, want))}
    cmp["held"] = bool(torch.isfinite(got).all()) \
        and cmp["max_abs"] <= cmp["tol_max"] \
        and cmp["median_abs"] <= cmp["tol_median"]
    return cmp


def phase_lm_serve(device):
    """Full-width minitron-4b (bf16, random seeded weights drawn on the
    card) served through ServeEngine, whose decode step is one captured
    graph: 4 requests; the replayed step against the eager one and K5
    against the plain attention; greedy streams against an eager and a
    plain-attention run; per-replay counts and wall clock."""
    import torch
    from repro_torch.kernels import flash_decode, matmul
    from repro_torch.models.decoder import decode_step, init_decoder

    cfg = lm_config()
    torch.cuda.reset_peak_memory_stats()
    params = init_decoder(cfg, torch.Generator(device=device).manual_seed(SEED),
                          device=device)
    param_bytes = sum(t.numel() * t.element_size() for _, t in leaf_paths(params))
    prompts = seeded_prompts(cfg.vocab_size)
    flash_decode.LAUNCHES = 0
    matmul.LAUNCHES = 0
    engine, reqs, steps, wall, memory = lm_serve_run(cfg, params, prompts,
                                                     device)
    launches = {"flash_decode": flash_decode.LAUNCHES,
                "matmul": matmul.LAUNCHES}
    peak = torch.cuda.max_memory_allocated()
    n_layers, n_steps = cfg.n_layers, len(steps)
    # the wrapper ran at the warm-up step and at the capture; every served
    # step was a replay
    if n_steps != LM_NEW_TOKENS - 1 or engine.compile_count != 1 \
            or launches != {"flash_decode": 2 * n_layers, "matmul": 0}:
        raise AssertionError(f"launch counts {launches} over {n_steps} decode "
                             f"steps, compile_count {engine.compile_count}; "
                             f"expected {2 * n_layers} flash_decode launches "
                             "(warm-up and capture), no matmul, one preparation")
    for r in reqs:
        if not (r.done and len(r.output) == LM_NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"request {r.rid}: done={r.done} "
                                 f"output={r.output}")
    if not all(s["finite"] for s in steps):
        raise AssertionError(f"non-finite decode logits: {steps}")

    # the next decode step from the served state: replayed against eager
    # on a copy of the cache (each writes the same slots before reading)
    tokens, pos = engine.last_tok.clone(), engine.pos.clone()
    cache_copy = {k: v.clone() for k, v in engine.cache.items()}
    with torch.inference_mode():
        eager_logits, _ = decode_step(engine.params, cfg, cache_copy, tokens,
                                      pos)
    del cache_copy
    replayed = engine.decode_logits()
    torch.cuda.synchronize()
    captured_cmp = logit_limits(replayed, eager_logits)
    if not captured_cmp["held"]:
        raise AssertionError(f"decode logits, captured vs eager: {captured_cmp}")
    # ... and K5 against the plain attention, both eager
    with torch.inference_mode():
        got, _ = decode_step(engine.params, cfg, engine.cache, tokens, pos)
        with PlainAttention():
            want, _ = decode_step(engine.params, cfg, engine.cache, tokens, pos)
    torch.cuda.synchronize()
    logit_cmp = logit_limits(got, want)
    if not logit_cmp["held"]:
        raise AssertionError(f"decode logits, K5 vs plain attention: {logit_cmp}")
    top2 = want.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    decided = gap > 2 * logit_cmp["tol_max"]
    agree = got.argmax(-1) == want.argmax(-1)
    if not bool(agree[decided].all()):
        raise AssertionError(f"greedy token differs where the top-2 gap "
                             f"{gap.tolist()} exceeds twice the tolerance")

    # one replay: 32 K5 calls (split and merge kernels), one graph launch
    replay = replay_counts(engine.decode_logits, (
        "flash_decode_mma_kernel", "flash_decode_split_kernel",
        "flash_decode_merge_kernel"))
    k = replay["kernels"]
    if k["flash_decode_mma_kernel"] + k["flash_decode_split_kernel"] != n_layers \
            or k["flash_decode_merge_kernel"] != n_layers:
        raise AssertionError(f"one decode replay: {replay}; expected "
                             f"{n_layers} split and {n_layers} merge kernels")
    check_replay("LM decode step", replay, {}, want_pinned=0)

    def eager_step():
        with torch.inference_mode():
            decode_step(engine.params, cfg, engine.cache, tokens, pos)
    timing = step_timing({"eager": eager_step, "captured": engine.decode_logits})
    capture = {"agreement": captured_cmp, "replay": replay, "steps": timing,
               "memory": memory, "compile_count": engine.compile_count}
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in engine.cache.values())
    lm_state = {"cache": engine.cache, "tokens": tokens, "pos": pos}
    del engine

    # the whole run again eagerly (its first decode step's first K5 call:
    # the timing phase's operands), and through the plain attention: how
    # often do the greedy streams agree with the captured run (random
    # heads have small top-2 gaps)
    rec = Recorder(flash_decode, "flash_decode", 1)
    eager_engine, eager_reqs, _, eager_wall, _ = lm_serve_run(
        cfg, params, prompts, device, eager=True, serving=rec)
    del eager_engine
    with PlainAttention():
        _, plain_reqs, _, plain_wall, _ = lm_serve_run(cfg, params, prompts,
                                                       device)
    same, first_diff = stream_agreement(reqs, plain_reqs)
    e_same, e_first = stream_agreement(reqs, eager_reqs)
    capture.update(eager_stream_tokens_agree=e_same,
                   eager_stream_first_difference=e_first,
                   eager_run_wall_s=eager_wall)
    emit("lm_serve", model=cfg.name, dtype=str(cfg.dtype),
         params=cfg.param_count(), param_bytes=param_bytes,
         cache_bytes=cache_bytes, max_batch=LM_MAX_BATCH,
         cache_len=LM_CACHE_LEN, prompts=list(LM_PROMPTS),
         new_tokens=LM_NEW_TOKENS, decode_steps=n_steps, wall_s=wall,
         eager_wall_s=eager_wall, plain_attention_wall_s=plain_wall,
         launches=launches, launches_per_replay=replay["kernels"],
         compile_count=capture["compile_count"],
         max_memory_allocated=peak, outputs=[r.output for r in reqs],
         decode_logits_captured_vs_eager=captured_cmp,
         decode_logits_vs_plain=logit_cmp, top2_gap=gap.tolist(),
         greedy_agree=agree.tolist(), greedy_decided=decided.tolist(),
         stream_tokens_agree=same, stream_first_difference=first_diff,
         eager_stream_tokens_agree=e_same,
         eager_stream_first_difference=e_first)
    args, kw = rec.calls[0]
    return {"cfg": cfg, "params": params, "launches": launches,
            "steps": n_steps, "param_bytes": param_bytes,
            "k5_call": ([t.clone() for t in args], kw), "prompts": prompts,
            "capture": capture, **lm_state}


# --------------------------------------------------------------------------
# phase 4b: streaming video through persistent value caches
# --------------------------------------------------------------------------

def stream_setup(device):
    """The streamed detector's decoder and heads at full width (random
    weights from the seed), its 512 px level shapes, and one drifting
    scene of STREAM_FRAMES encoder memories per session."""
    import torch
    from repro_torch.core.detector import init_detector
    from repro_torch.msda.plan import level_shapes_for_resolution
    from repro_torch.stream import drifting_scene
    cfg = slice_config("deformable-detr-defa")
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    levels = level_shapes_for_resolution(cfg.img_size)
    d = cfg.encoder.attn.d_model
    scenes = [[f[0] for f in drifting_scene(STREAM_SEED + i, levels, d,
                                            STREAM_FRAMES)]
              for i in range(STREAM_SESSIONS)]
    return {"attn": cfg.encoder.attn, "dec_cfg": cfg.decoder, "levels": levels,
            "params": {k: params[k] for k in ("decoder", "cls_head",
                                              "box_head")},
            "scenes": scenes}


def stream_attn(setup, table_dtype=None, act_bits="config"):
    import dataclasses
    attn = setup["attn"]
    if table_dtype is not None:
        attn = dataclasses.replace(attn, table_dtype=table_dtype)
    if act_bits != "config":
        attn = dataclasses.replace(attn, act_bits=act_bits)
    return attn


def profile_step(fn):
    """One call of ``fn`` under torch.profiler (a warm-up step first, so
    that tracing runs when the call starts): wall ms, device busy ms and
    idle share, K2 launches, device kernels, pageable host-to-device
    copies."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, schedule
    warm = torch.zeros(1, device="cuda")
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm.add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    busy = sum(_device_us(e) for e in dev) / 1e3
    count = lambda frag: sum(e.count for e in dev if frag in e.key)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "k2_launches": count("msgs_decode_kernel"),
            "device_kernels": sum(e.count for e in dev),
            "htod_pageable": count("Memcpy HtoD (Pageable")}


def stream_pass(setup, device, attn, order, *, scfg=None, profiled=False,
                reorder_before=None, keep_tables=False, obs=None):
    """One StreamingDetrEngine over the scenes: the session opened k-th
    (slot k) streams scene ``order[k]``; one engine step per frame. Per
    frame: the memory, the FWP state the cache was built under, the
    frame stats, the outputs on the device (and, with ``keep_tables``,
    copies of the value table, staged table and scale), the host wall
    clock of the step (or, ``profiled``, one profiler step). The K2 calls
    of the last frame are kept. With ``reorder_before`` the engine
    reorders its sessions before that frame."""
    import torch
    from repro_torch.kernels import msgs_decode
    from repro_torch.obs import Observability
    from repro_torch.serve import StreamingDetrEngine
    engine = StreamingDetrEngine(
        attn, setup["dec_cfg"], setup["params"], setup["levels"],
        max_sessions=STREAM_SESSIONS, backend="cuda_decode",
        stream_cfg=scfg, obs=obs or Observability.disabled(), device=device)
    scene_of = {engine.open_session(): scene for scene in order}
    records, steps, mapping = [], [], None
    real_forward = engine.forward

    def forward(memory, cache):
        logits, boxes, freq = real_forward(memory, cache)
        rec = {"memory": memory, "fwp": engine.mgr.fwp,
               "act_scale": engine.mgr.act_scale,
               "stats": dict(engine.mgr.last_stats),
               "outputs": (logits, boxes)}
        if keep_tables:
            rec["tables"] = tuple(None if t is None else t.clone()
                                  for t in (cache.v, cache.staged.v,
                                            cache.scale))
        records.append(rec)
        return logits, boxes, freq
    engine.forward = forward
    n_layers = setup["dec_cfg"].n_layers
    with Recorder(msgs_decode, "msgs_decode",
                  STREAM_FRAMES * n_layers) as rec_d:
        for t in range(STREAM_FRAMES):
            if t == reorder_before:
                before = {sid: s.slot for sid, s in engine.sessions.items()}
                mapping = {"before": before,
                           "after": engine.reorder_sessions()}
            for sid, scene in scene_of.items():
                engine.submit_frame(sid, setup["scenes"][scene][t])
            if profiled:
                steps.append(profile_step(engine.step))
            else:
                t0 = time.perf_counter()
                engine.step()
                torch.cuda.synchronize()
                steps.append({"wall_ms": (time.perf_counter() - t0) * 1e3})
    engine.forward = real_forward
    results = {scene: [(r["cls_probs"], r["boxes"])
                       for r in engine.sessions[sid].results]
               for sid, scene in scene_of.items()}
    return {"engine": engine, "records": records, "steps": steps,
            "results": results, "mapping": mapping,
            "k2_calls": rec_d.calls[-n_layers:]}


def stream_scratch(run, rec):
    """The frame's outputs through ``decoder_apply`` on a cache built from
    scratch from the frame's memory under the FWP state its streamed
    cache was built with; and that cache."""
    from repro_torch.msda.cache import build_value_cache
    from repro_torch.msda.pipeline import MSDAPipelineState
    engine = run["engine"]
    cache = build_value_cache(engine.params["decoder"]["value"], engine.plan,
                              rec["memory"], MSDAPipelineState(fwp=rec["fwp"]))
    logits, boxes, _ = engine.forward(rec["memory"], cache)
    return (logits, boxes), cache


def wall_split(steps, records):
    """Median, p10 and p90 of the step wall clock per frame mode."""
    out = {}
    for mode in ("rebuild", "partial", "incremental"):
        ts = [s["wall_ms"] for s, r in zip(steps, records)
              if r["stats"]["mode"] == mode]
        if not ts:
            continue
        dec = statistics.quantiles(ts, n=10) if len(ts) > 1 else [ts[0]] * 9
        out[mode] = {"n": len(ts), "median_ms": statistics.median(ts),
                     "p10_ms": dec[0], "p90_ms": dec[-1]}
    return out


def stream_frames(run):
    return [{k: r["stats"][k] for k in ("mode", "reason", "n_dirty",
                                         "tiles_changed", "staged_bytes",
                                         "rebuild_bytes", "restaged_levels")}
            for r in run["records"]]


def stream_same_grid(run, rec):
    """The frame's outputs through ``decoder_apply`` on a table whose every
    slot is re-projected from the frame's memory under the streamed
    cache's geometry and FROZEN scales (the activation grid and the int8
    table scale the stream quantizes against); and that table. A
    streamed table must equal it up to float ulps, wherever its rows
    were last written."""
    import torch
    from repro_torch.core.quant import quantize_table_rows
    from repro_torch.kernels import msgs_decode
    from repro_torch.msda.cache import project_cache_rows
    engine = run["engine"]
    fwp, scale = rec["fwp"], rec["tables"][2]
    rows = project_cache_rows(engine.params["decoder"]["value"],
                              engine.plan.cfg, rec["memory"], fwp.keep_idx,
                              act_scale=rec["act_scale"])
    if scale is not None:
        rows = quantize_table_rows(rows, scale)
    table = torch.cat([rows, torch.zeros_like(rows[:, :1])], dim=1)
    staged = msgs_decode.stage_decode_table(
        table, fwp.pix2slot, head_pack=engine.plan.decode_head_pack,
        scale=scale)
    cache = engine.mgr.cache._replace(v=table, pix2slot=fwp.pix2slot,
                                      keep_idx=fwp.keep_idx, scale=scale,
                                      staged=staged)
    logits, boxes, _ = engine.forward(rec["memory"], cache)
    return (logits, boxes), table


def stream_against_scratch(label, run, compare, tol=None, fresh_limits=True):
    """Each frame's outputs against a scratch build of the frame
    (``stream_scratch``): within ``tol`` (rtol = atol) when given, else
    DEFA's limits when ``fresh_limits``, else reported only. With the
    frames' tables kept, also against the same-grid table
    (``stream_same_grid``, DEFA's limits always), with the share of table
    elements that differ from each."""
    import torch
    out = {"per_frame": [], "same_grid": [], "fresh_share_differing": [],
           "same_grid_share_differing": []}
    for t, rec in enumerate(run["records"]):
        want, cache = stream_scratch(run, rec)
        got = rec["outputs"]
        if tol is not None:
            for i, name in enumerate(OUTPUTS):
                if not torch.allclose(got[i], want[i], rtol=tol, atol=tol):
                    raise AssertionError(
                        f"{label} frame {t} {name}: streamed vs scratch max "
                        f"{float((got[i] - want[i]).abs().max()):.3e} > {tol}")
        elif fresh_limits:
            defa_agreement(f"{label}/frame{t}", got, want, compare)
        out["per_frame"].append(abs_errors(got, want))
        if "tables" not in rec:
            continue
        v = rec["tables"][0]
        out["fresh_share_differing"].append(float((v != cache.v).float()
                                                  .mean()))
        same, table = stream_same_grid(run, rec)
        defa_agreement(f"{label}/same_grid/frame{t}", got, same, compare)
        out["same_grid"].append(abs_errors(got, same))
        out["same_grid_share_differing"].append(float((v != table).float()
                                                      .mean()))
    return out


def stream_threshold0(label, run, bitwise):
    """``delta_threshold=0, update_frac=1``: every frame's streamed table,
    staged table and outputs against a rebuild of the frame. ``bitwise``:
    raise unless equal."""
    import torch
    out = []
    for t, rec in enumerate(run["records"]):
        want, cache = stream_scratch(run, rec)
        v, staged, _ = rec["tables"]
        eq = {"table": torch.equal(v, cache.v),
              "staged": torch.equal(staged, cache.staged.v),
              "outputs": all(torch.equal(a, b)
                             for a, b in zip(rec["outputs"], want))}
        row = {"mode": rec["stats"]["mode"], "bitwise": eq,
               "code_share_differing": float((v != cache.v).float().mean()),
               **{k: e for k, e in abs_errors(rec["outputs"], want).items()}}
        out.append(row)
        if bitwise and not all(eq.values()):
            raise AssertionError(f"{label} frame {t}: threshold-0 stream vs "
                                 f"rebuild not bitwise: {row}")
    return out


def stream_staged_checks(run):
    """After the last (incremental) frame: a fresh staging of the updated
    table equals the staged table bitwise; K2 on the staged table equals
    K2 on the fresh staging bitwise and its plain version within the
    kernel tolerance (each decoder layer's call of the last frame)."""
    import torch
    from repro_torch.kernels import msgs_decode
    cache = run["engine"].mgr.cache
    fresh = msgs_decode.stage_decode_table(
        cache.v, cache.pix2slot, head_pack=cache.staged.head_pack,
        scale=cache.scale)
    if not torch.equal(fresh.v, cache.staged.v):
        raise AssertionError("stream: the updated staged table differs from "
                             "a fresh staging of the updated table")
    errs = []
    for args, _ in run["k2_calls"]:
        staged, pts = args[0], args[1:7]
        if staged.v.data_ptr() != cache.staged.v.data_ptr():
            raise AssertionError("stream: K2 sampled a copy of the staged "
                                 "table, not the table the update wrote")
        out = msgs_decode.msgs_decode(staged, *pts)
        if not torch.equal(out, msgs_decode.msgs_decode(fresh, *pts)):
            raise AssertionError("stream: K2 on the updated staged table vs "
                                 "on a fresh staging: not bitwise equal")
        plain = msgs_decode.msgs_decode_plain(
            staged.v, *(t[:, None] for t in pts), staged.remap, staged.scale,
            head_pack=staged.head_pack, dh=staged.dh)[:, 0]
        errs.append(check_close("msgs_decode on the streamed table", out,
                                plain, tolerance(staged.v.dtype,
                                                 staged.scale)))
    return {"staged_equals_fresh_staging": True,
            "k2_updated_equals_fresh": True, "k2_vs_plain_max_abs_err": errs,
            "last_frame_mode": run["records"][-1]["stats"]["mode"]}


def sorted_layout(run, t):
    """The slot layout (scene per slot) that reorder_sessions would sort
    the sessions of ``run`` into after frame ``t``: scenes ordered by the
    raster key of their predicted-box centroid."""
    import numpy as np
    import torch
    from repro_torch.msda import ordering
    engine = run["engine"]
    scenes = sorted(run["results"])
    cents = np.stack([run["results"][s][t][1][:, :2].mean(axis=0)
                      for s in scenes]).astype(np.float32)
    keys = ordering.query_sort_keys(torch.from_numpy(cents)[None],
                                    engine.plan.level_shapes, "raster")[0]
    return [scenes[int(i)] for i in np.argsort(keys.numpy(), kind="stable")]


def stream_table(setup, device, table, obs_log=None):
    """One table dtype at the config's INT12: a timed pass, a profiled
    pass, outputs against scratch builds (DEFA's limits), launches, wall
    clock by mode, busy and idle share, peak memory."""
    import torch
    from repro_torch.kernels import (flash_decode, matmul, msgs_decode,
                                     msgs_fused, msgs_windowed)
    from repro_torch.obs import Observability
    attn = stream_attn(setup, table_dtype=table)
    mods = {"msgs_decode": msgs_decode, "msgs_fused": msgs_fused,
            "msgs_windowed": msgs_windowed, "flash_decode": flash_decode,
            "matmul": matmul}
    for m in mods.values():
        m.LAUNCHES = 0
    obs = Observability.default() if obs_log else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed = stream_pass(setup, device, attn, list(range(STREAM_SESSIONS)),
                        keep_tables=True, obs=obs)
    launches = {n: m.LAUNCHES for n, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() - base
    frames = len(timed["records"])
    if launches != {"msgs_decode": setup["dec_cfg"].n_layers * frames,
                    "msgs_fused": 0, "msgs_windowed": 0, "flash_decode": 0,
                    "matmul": 0}:
        raise AssertionError(f"stream {table}: launches {launches} over "
                             f"{frames} frames; expected 6 K2 per frame only")
    log = None
    if obs_log:
        timed["engine"].obs.flush_metrics()
        timed["engine"].obs.close()
        log = validate_log(obs_log, STREAM_METRICS)
    profiled = stream_pass(setup, device, attn, list(range(STREAM_SESSIONS)),
                           profiled=True)
    modes = [r["stats"]["mode"] for r in timed["records"]]
    if modes != [r["stats"]["mode"] for r in profiled["records"]]:
        raise AssertionError(f"stream {table}: the profiled pass took other "
                             f"modes than the timed one: {modes}")
    bad = [s["k2_launches"] for s in profiled["steps"]
           if s["k2_launches"] != setup["dec_cfg"].n_layers]
    if bad:
        raise AssertionError(f"stream {table}: K2 launches per frame "
                             f"{[s['k2_launches'] for s in profiled['steps']]}")
    compare = {}
    # an int8 scratch build quantizes against a FRESH per-channel scale,
    # which a keep transition can move far from the frozen one: its
    # distance is reported; the same-grid table is what the stream must hold
    scratch = stream_against_scratch(f"stream_{table}", timed, compare,
                                     fresh_limits=table != "int8")
    report = timed["engine"].report()
    busy = [s["device_busy_ms"] for s in profiled["steps"]]
    rec = {"table_dtype": table, "frames": stream_frames(timed),
           "report": report, "launches": launches,
           "k2_launches_per_frame": [s["k2_launches"]
                                     for s in profiled["steps"]],
           "htod_pageable_per_frame": [s["htod_pageable"]
                                       for s in profiled["steps"]],
           "wall_ms_by_mode": wall_split(timed["steps"], timed["records"]),
           "profiled": {"wall_ms": [s["wall_ms"] for s in profiled["steps"]],
                        "device_busy_ms": busy,
                        "idle_share": [s["idle_share"]
                                       for s in profiled["steps"]],
                        "device_kernels": [s["device_kernels"]
                                           for s in profiled["steps"]]},
           "peak_allocated_bytes": peak, "against_scratch": scratch,
           "defa_limits": compare, "staged": stream_staged_checks(timed),
           "obs_log": log, "capacity": timed["engine"].capacity_estimate(),
           "plan": timed["engine"].describe()}
    return rec, timed


def stream_reorder(setup, device, timed):
    """reorder_sessions against an engine that does not reorder, from the
    same slot layout, on the same frames: each session's detections of
    the frame after the move must be bitwise unchanged. The layout is
    chosen so that the sort moves the sessions."""
    attn = stream_attn(setup)
    layout = sorted_layout(timed, STREAM_FRAMES - 2)[::-1]
    last = STREAM_FRAMES - 1
    control = stream_pass(setup, device, attn, layout)
    moved = stream_pass(setup, device, attn, layout, reorder_before=last)
    equal = {}
    for scene in control["results"]:
        a, b = control["results"][scene][last], moved["results"][scene][last]
        equal[scene] = all((x == y).all() for x, y in zip(a, b))
    out = {"layout": layout, "mapping": {k: {str(s): v for s, v in m.items()}
                                         for k, m in moved["mapping"].items()},
           "moved": moved["mapping"]["before"] != moved["mapping"]["after"],
           "next_detections_bitwise_equal": equal}
    if not all(equal.values()):
        raise AssertionError(f"stream: reorder_sessions changed the next "
                             f"detections: {out}")
    return out


def query_order_check(serve, device):
    """The 512 px bucket with query_order="zorder" (encoder and decoder
    queries sorted by the Morton key of their reference points) against
    the same detector with "none": the captured forward and the eager one
    must give bitwise the outputs of "none"."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.detector import detector_apply
    from repro_torch.obs import Observability
    from repro_torch.serve import DetrServeEngine
    cfg = serve["cfg"]
    enc = cfg.encoder
    cfg_z = dataclasses.replace(cfg, encoder=dataclasses.replace(
        enc, attn=dataclasses.replace(enc.attn, query_order="zorder")))
    images = seeded_images(MAX_BATCH)
    x = torch.from_numpy(np.stack(images)).to(device)
    with torch.inference_mode():
        want = detector_apply(serve["params"], cfg, x, backend="auto")[:2]
        eager = detector_apply(serve["params"], cfg_z, x, backend="auto")[:2]
    with DetrServeEngine(cfg_z, serve["params"], max_batch=MAX_BATCH,
                         backend="auto", obs=Observability.disabled(),
                         device=device) as engine:
        plan = engine.buckets[0].plan
        logits, boxes, ready = engine.dispatch(images, IMG)
        ready.synchronize()
    out = {"plan_query_order": plan.query_order,
           "eager_bitwise": all(torch.equal(a, b) for a, b in zip(eager, want)),
           "captured_bitwise": all(torch.equal(a, b) for a, b in
                                   zip((logits, boxes), want)),
           "eager_vs_none": abs_errors(eager, want),
           "captured_vs_none": abs_errors((logits, boxes), want)}
    if plan.query_order != "zorder" or not (out["eager_bitwise"]
                                            and out["captured_bitwise"]):
        raise AssertionError(f"query_order zorder vs none: {out}")
    return out


def phase_stream(device, serve):
    """StreamingDetrEngine at full width: 2 sessions x 8 drifting-scene
    frames through K2 on persistent staged tables, f32 then int8 (the
    config's INT12); the same with act_bits None (outputs within 1e-5 of
    scratch builds); delta_threshold 0 (f32: bitwise a rebuild; int8:
    what holds is reported); reorder_sessions; query ordering on the
    512 px bucket; the stream log through the validator."""
    from repro_torch.stream import StreamConfig
    t_phase = time.perf_counter()
    setup = stream_setup(device)
    with obs_log_env() as log:
        f32, timed = stream_table(setup, device, "float32", obs_log=log)
    int8, int8_run = stream_table(setup, device, "int8")
    reorder = stream_reorder(setup, device, timed)
    del timed
    exact = stream_pass(setup, device, stream_attn(setup, act_bits=None),
                        list(range(STREAM_SESSIONS)))
    no_int12 = stream_against_scratch("stream_act_none", exact, {}, tol=1e-5)
    del exact
    t0 = StreamConfig(delta_threshold=0.0, update_frac=1.0)
    run = stream_pass(setup, device, stream_attn(setup, act_bits=None),
                      list(range(STREAM_SESSIONS)), scfg=t0, keep_tables=True)
    thr0_f32 = stream_threshold0("float32", run, bitwise=True)
    run = stream_pass(setup, device,
                      stream_attn(setup, table_dtype="int8", act_bits=None),
                      list(range(STREAM_SESSIONS)), scfg=t0, keep_tables=True)
    thr0_int8 = stream_threshold0("int8", run, bitwise=False)
    del run
    order = query_order_check(serve, device)
    emit("stream", model="deformable-detr-defa", img=IMG,
         seconds=time.perf_counter() - t_phase,
         n_in=int(setup["scenes"][0][0].shape[0]),
         sessions=STREAM_SESSIONS, frames=STREAM_FRAMES,
         float32=f32, int8=int8, act_bits_none_vs_scratch=no_int12,
         threshold0={"float32": thr0_f32, "int8": thr0_int8},
         reorder=reorder, query_order=order)
    return {"int8_k2_calls": int8_run["k2_calls"],
            "int8_launches": int8["launches"]["msgs_decode"],
            "f32": f32, "int8": int8}


# --------------------------------------------------------------------------
# phase 4c: the measured plan table on the card
# --------------------------------------------------------------------------

def served_picks():
    """``auto``'s pick in the encoder and the decoder of each served bucket
    under whatever plan-table entry is applied (the 1024 px int8 encoder
    is served by name through cuda_windowed; the trainer's decoder by
    name through cuda_decode; the stream engines have no encoder), plus a
    table over every budget with no range narrowing (1280 px, the window
    gate closed), where the reference falls back to its gather. Every
    pick for the card must be a CUDA kernel."""
    import dataclasses
    from repro_torch.msda.plan import level_shapes_for_resolution, plan_for
    from repro_torch.train.detr import train_config
    cfg = slice_config("deformable-detr-defa")
    f32 = cfg.encoder.attn
    int8 = dataclasses.replace(f32, table_dtype="int8")
    train = train_config("deformable-detr-defa", IMG).encoder.attn
    buckets = {"512px_float32": (f32, IMG, True),
               "1024px_int8": (int8, IMG_WINDOWED, True),
               "1024px_float32_mixed": (f32, IMG_WINDOWED, True),
               "train_512px": (train, IMG, True),
               "stream_512px_float32": (f32, IMG, False),
               "stream_512px_int8": (int8, IMG, False),
               "1280px_float32_no_narrow": (
                   dataclasses.replace(f32, range_narrow=None), 1280, True)}
    out = {}
    for name, (attn, img, encoder) in buckets.items():
        levels = level_shapes_for_resolution(img)
        picks = {"decoder": plan_for(attn, levels, "auto", cfg.decoder.n_queries,
                                     cfg.decoder.n_layers).backend}
        if encoder:
            picks["encoder"] = plan_for(attn, levels, "auto").backend
        out[name] = picks
    plain = {k: v for k, v in out.items() if "torch_gather" in v.values()}
    if plain:
        raise AssertionError(f"auto picked the plain gather on the card: "
                             f"{plain}")
    return out


def decoder_tile_windows(serve):
    """``with_measured_tile_window`` on the 512 px decoder's reference
    points (the first layer's, from the served weights): per-tile window
    bytes unordered and under zorder, max and mean."""
    import dataclasses
    import torch
    from repro_torch.core import nn
    from repro_torch.msda.plan import level_shapes_for_resolution, plan_for
    cfg = slice_config("deformable-detr-defa")
    dec = serve["params"]["decoder"]
    with torch.no_grad():
        refs = torch.sigmoid(nn.linear(dec["ref_head"], dec["query_pos"]))
    attn = dataclasses.replace(cfg.encoder.attn, query_order="zorder")
    plan = plan_for(attn, level_shapes_for_resolution(IMG), "auto",
                    cfg.decoder.n_queries, cfg.decoder.n_layers)
    umax, umean, zmax, zmean = plan.with_measured_tile_window(
        refs.cpu().numpy()).measured_tilewin
    return {"tile_q": plan.tile_q, "n_queries": int(refs.shape[0]),
            "unordered": {"max_bytes": umax, "mean_bytes": umean},
            "zorder": {"max_bytes": zmax, "mean_bytes": zmean},
            "static_window_bytes": plan_for(cfg.encoder.attn,
                                            level_shapes_for_resolution(IMG),
                                            "auto").window_bytes}


def phase_autotune(device, smi, serve):
    """The port's plan autotuner on the card: the three calibrations
    measured into a temporary table (the committed
    results/autotune_torch.json must not change), measured provenance,
    the tuned auto picks bitwise the same backends planned statically at
    the 512 px shape (encoder and decoder), the probed sizes straddling
    the L2, each served bucket's static and measured auto picks, and the
    512 px decoder's measured tile windows. The phase runs in a plan-table
    scope: every later phase plans statically."""
    import torch
    from repro_torch.msda import autotune
    from repro_torch.msda import plan as plan_lib
    t_phase = time.perf_counter()
    committed = Path(autotune.default_table_path())
    before = committed.read_bytes() if committed.exists() else None
    l2 = int(torch.cuda.get_device_properties(device).L2_cache_size)
    with autotune.plan_table_scope():
        static = served_picks()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "autotune_torch.json")
            entry = autotune.plan_autotune(device=device, measure=True,
                                           force=True, cache_path=path)
            persisted = autotune.load_table(path)["platforms"][
                autotune.platform_key(device)]
        if persisted != entry or entry["provenance"] != "measured" \
                or not autotune.valid_entry(entry):
            raise AssertionError(f"autotune entry not persisted as measured: "
                                 f"{entry}")
        sizes = [mb * 2**20 for mb in
                 entry["calibration"]["staging_budget"]["sizes_mb"]]
        if not min(sizes) < l2 < max(sizes):
            raise AssertionError(f"probed sizes {sizes} do not straddle the "
                                 f"L2 ({l2} B)")
        measured = served_picks()
        cfg, levels, shape = autotune.calibration_shape(device)
        desc = plan_lib.plan_for(cfg, levels, "auto", shape["n_queries"],
                                 shape["n_layers"]).describe()
        if "budget=measured" not in desc:
            raise AssertionError(f"plan provenance is not measured: {desc}")
        check = autotune.tuned_vs_static(cfg, levels, device, **shape)
        if not all(r["bitwise"] for r in check.values()):
            raise AssertionError(f"tuned auto picks differ from static: {check}")
        tile = decoder_tile_windows(serve)
    if plan_lib.tuned_entry(device) is not None:
        raise AssertionError("a card entry outlived the autotune phase")
    after = committed.read_bytes() if committed.exists() else None
    if after != before:
        raise AssertionError(f"{committed} changed during the autotune phase")
    torch.cuda.synchronize()
    emit("autotune", card=smi, l2_bytes=l2, platform=entry["platform"],
         provenance=entry["provenance"],
         staging_budget_bytes=entry["staging_budget_bytes"],
         decode_sweep_beneficial=entry["decode_sweep_beneficial"],
         decode_persistent_speedup=entry["decode_persistent_speedup"],
         stream=entry["stream"], check_describe=desc,
         tuned_vs_static_512px=check,
         picks={"static": static, "measured": measured},
         tile_window_512px_decoder=tile,
         calibration=entry["calibration"], table_unchanged=True,
         seconds=time.perf_counter() - t_phase)


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
    """torch.profiler over ``calls`` calls of ``fn``: (device kernel
    events, cpu op events, wall ms of those calls). One call runs before
    the profiler starts and one in its warm-up step, whose events are
    dropped, so that tracing is already running when the counted calls
    start. Device events are the kernels on the card, with their own
    durations."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, schedule
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        prof.step()
    # the schedule also marks each step on the device timeline
    # ("ProfilerStep#N", spanning its kernels): not a kernel
    events = [e for e in prof.key_averages()
              if not e.key.startswith("ProfilerStep")]
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


def k1_on_k2_operands(staged, pts):
    """K1 on the operands of one one-layer K2 call: the staged table
    unstaged to (B, N_rows, H, Dh), the same points, remap and scale."""
    from repro_torch.kernels import msgs_decode, msgs_fused
    b, h = pts[0].shape[0], pts[0].shape[2]
    v = msgs_decode._unstage_layout(staged.v, staged.head_pack,
                                    staged.dh).contiguous()
    scale = None if staged.scale is None else \
        staged.scale.reshape(b, 1, h, staged.dh)
    return msgs_fused.msgs_fused(v, *pts, remap=staged.remap, scale=scale)


def k2_entry(staged, pts, launches):
    """K2 on one decoder layer's call: the summary row and its detail,
    with K1's output on the same operands beside it (the gather engine
    is theirs in common: the design aims at no difference)."""
    from repro_torch.kernels import msgs_decode
    out = msgs_decode.msgs_decode(staged, *pts)
    layered = tuple(t[:, None] for t in pts)
    plain = lambda: msgs_decode.msgs_decode_plain(
        staged.v, *layered, staged.remap, staged.scale,
        head_pack=staged.head_pack, dh=staged.dh)
    err = check_close("msgs_decode timing operands", out, plain()[:, 0],
                      tolerance(staged.v.dtype, staged.scale))
    entry = {"name": "msgs_decode", "route": "cuda",
             "source": "src/repro_torch/csrc/msgs_decode.cu",
             "replaces": "src/repro/kernels/msgs_decode.py:231",
             "launches": launches, "max_abs_err": err,
             **kernel_times(lambda: msgs_decode.msgs_decode(staged, *pts),
                            plain, "msgs_decode_kernel"),
             "library_ms": None}
    # staged rows are per head group; count (b, head, row) like K1
    bound = kernel_bound(pts, staged.remap, staged.scale, out, staged.n_rows,
                         pts[0].shape[2], staged.dh, staged.v.element_size())
    entry.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    return entry, dict(bound, shape=list(pts[0].shape),
                       table=list(staged.v.shape), dtype=str(staged.v.dtype),
                       max_abs_diff_vs_k1=float(
                           (out.float() - k1_on_k2_operands(staged, pts).float())
                           .abs().max()))


def table_grad_chain(calls, reps=10):
    """Device time of one train step's table-gradient chain, replayed on
    the K2 backward operands of the step's decoder layers (``calls``, as
    the Recorder kept them): a leaf (B, N_rows, H, Dh) table staged as the
    decoder stages it, one MsgsDecode node per layer, and one
    autograd.grad through them. The window holds the layers' K2 backward
    calls (with any fill they make), autograd's adds of their d_vp and the
    staging's backward; the forward runs before it. Profiler device time
    per pass, and the kernels by device time."""
    import torch
    from repro_torch.kernels import msgs_decode
    vp, remap, g, dh = (calls[0][0][i] for i in (0, 8, 10, 11))
    table = msgs_decode._unstage_layout(vp, g, dh).contiguous()
    g_outs = [args[7] for args, _ in calls]
    graphs = []
    for _ in range(reps + 2):            # profile's two warm-up calls, reps
        leaf = table.detach().requires_grad_()
        staged = msgs_decode.stage_decode_table(leaf, remap, head_pack=g)
        with torch.enable_grad():
            outs = [msgs_decode.MsgsDecode.apply(staged.v, *args[1:7], remap,
                                                 None, g, dh)
                    for args, _ in calls]
        graphs.append((leaf, outs))

    def backward():
        leaf, outs = graphs.pop()
        torch.autograd.grad(outs, leaf, grad_outputs=g_outs)
    dev, _, wall = profile(backward, reps)
    top = sorted(dev, key=_device_us, reverse=True)[:8]
    return {"ms": sum(_device_us(e) for e in dev) / reps / 1e3,
            "layers": len(calls), "wall_ms_per_pass": wall / reps,
            "kernels": [{"op": e.key[:90], "count": e.count // reps,
                         "ms": _device_us(e) / reps / 1e3} for e in top]}


def first_step_backward_calls(device):
    """The K2 backward operands of the train phase's first step (its
    model, parameters and batch), one per decoder layer."""
    import torch
    from repro_torch.core.detector import init_detector
    from repro_torch.data.detection import synth_detection_batch
    from repro_torch.kernels import msgs_decode
    from repro_torch.train.detr import loss_and_grads, train_config
    cfg = train_config("deformable-detr-defa", IMG)
    params = init_detector(cfg, torch.Generator().manual_seed(SEED),
                           device=device)
    batch = synth_detection_batch(torch.Generator().manual_seed(SEED),
                                  MAX_BATCH, IMG, cfg.level_shapes,
                                  cfg.n_classes, device=device)
    with Recorder(msgs_decode, "_backward", cfg.decoder.n_layers) as rec:
        loss_and_grads(params, cfg, batch, backend="cuda_decode")
    return rec.calls


def backward_bound(pts, remap, scale, g_out, vp, h, dh):
    """Least time for K2's backward: the points, g_out, the whole remap and
    the table rows that the valid corners touch read once; the dense d_vp
    in the table's dtype (or d_scale) and the three point gradients
    written once; the operations of ``FLOPS_PER_CHANNEL_CORNER_*``."""
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
        nbytes += vp.numel() * vp.element_size()
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


def phase_times(serve, serve_w, train, lm, stream):
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

    # K2: the first decoder layer's call on the once-staged table, and
    # the 1024 px path's first (int8 staged table)
    args, _ = serve["decode_calls"][0]
    k2, detail["msgs_decode"] = k2_entry(args[0], args[1:7],
                                         serve["launches"]["msgs_decode"])
    kernels.append(k2)
    args, _ = serve_w["decode_calls"][0]
    k2w, d2w = k2_entry(args[0], args[1:7], serve_w["launches"]["msgs_decode"])
    detail["msgs_decode"]["int8_1024"] = dict(
        d2w, **{k: k2w[k] for k in ("ms", "ms_source", "by_kernel", "call_ms",
                                     "plain_ms", "max_abs_err", "launches",
                                     "bound_ms", "bound_by")})
    # ... and the stream path's: the first decoder layer of the int8 run's
    # last frame, on the staged table the frame's update rewrote in place
    args, _ = stream["int8_k2_calls"][0]
    k2s, d2s = k2_entry(args[0], args[1:7], stream["int8_launches"])
    detail["msgs_decode"]["int8_stream"] = dict(
        d2s, **{k: k2s[k] for k in ("ms", "ms_source", "by_kernel", "call_ms",
                                     "plain_ms", "max_abs_err", "launches",
                                     "bound_ms", "bound_by")})

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
    first = call()
    check_bitwise("main path", first, call())
    errs = check_backward("main path", first, plain(), vp.dtype, scale)
    kb = {"name": "msgs_decode_backward", "route": "cuda",
          "source": "src/repro_torch/csrc/msgs_decode_bwd.cu",
          "replaces": "src/repro/kernels/msgs_decode.py:350",
          "launches": train["launches"]["msgs_decode_backward"],
          "max_abs_err": max(errs.values()),
          **kernel_times(call, plain, K2_BWD_KERNELS),
          "library_ms": None}
    h = pts[0].shape[3]
    bb = backward_bound(pts, remap, scale, g_out, vp, h, dh)
    kb.update(bound_ms=bb["bound_ms"], bound_by=bb["bound_by"])
    kernels.append(kb)
    dev, _, _ = profile(call, 20)
    detail["msgs_decode_backward"] = dict(
        bb, shape=list(pts[0].shape), table=list(vp.shape), dtype=str(vp.dtype),
        max_abs_err_by_output=errs, kernels=list(K2_BWD_KERNELS),
        wrapper_device_ms=sum(_device_us(e) for e in dev) / 20 / 1e3,
        table_grad_chain=table_grad_chain(train["backward_calls"]))

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
    replay = lambda rec, name: rec["capture"]["replay"]["kernels"][name]
    lm_k5 = lm["capture"]["replay"]["kernels"]
    per_forward = {
        "msgs_fused": replay(serve, "msgs_fused_kernel"),
        "msgs_decode": replay(serve, "msgs_decode_kernel"),
        "msgs_windowed": replay(serve_w, "msgs_windowed_kernel"),
        "msgs_decode_backward": train["launches"]["msgs_decode_backward"]
        // train["steps"],
        "flash_decode": lm_k5["flash_decode_mma_kernel"]
        + lm_k5["flash_decode_split_kernel"], "matmul": 0}
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
         launches_per_forward=per_forward,
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
    chain_src = None
    if sys.argv[1:2] == ["--table-grad-chain"] and len(sys.argv) == 3:
        chain_src = Path(sys.argv[2]).resolve()
    src = chain_src or Path(__file__).resolve().parent / "src"
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

    smi = phase_device()
    if chain_src is not None:
        emit("table_grad_chain", src=str(chain_src),
             **table_grad_chain(first_step_backward_calls(device)))
        return 0
    phase_build()
    from repro_torch.msda.plan import level_shapes_for_resolution
    phase_kernel_checks(device, level_shapes_for_resolution(IMG))
    phase_windowed_checks(device)
    phase_decode_grad(device, level_shapes_for_resolution(IMG))
    phase_lm_kernels(device)
    serve = phase_serve(device)
    serve_w = phase_serve_windowed(device)
    mixed = serve_mixed(device)
    train = phase_train(device)
    lm = phase_lm_serve(device)
    stream = phase_stream(device, serve)
    emit("capture", detector_512=serve["capture"],
         detector_512_plain=serve["plain_capture"],
         detector_1024=serve_w["capture"], mixed_buckets=mixed,
         lm_decode=lm["capture"], obs_log=serve["obs_log"])
    phase_autotune(device, smi, serve)
    kernels = phase_times(serve, serve_w, train, lm, stream)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
