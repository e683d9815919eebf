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
                hymba-1.5b's (B 4, 25 over 5 heads, Dh 64, windowed) and
                llava-next-34b's (B 1, 56 over 8, Dh 128),
                a ragged W, Hkv not dividing Hq, MQA, ring-buffer masks,
                rows with no valid slot and K5's split edges (W not a
                multiple of the split, splits with no valid slot, one
                valid slot at W - 1, B * Hkv = 1), each with its split
                plan; K4 in f32, bf16 and int8 + scale on the reference's
                shapes, minitron-4b's prefill and decode MLP-up products
                and the wgmma route's edges (M 1 and 65, K 3000, int8 with
                N % 16 == 0 or not), each with its route (the bf16 and int8
                prefill products must take "wgmma"); K5's partial mode
                (float32 output and log-sum-exp, a row with no valid slot
                exactly lse -inf and zero) on 4 slot shards merged in rank
                order against the whole cache, and on one rank's 131,072
                slots of hymba-1.5b's global layer;
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
     train_loop — the same detector trained through train_loop in a child
                process (``chip_smoke.py --train-loop``) under
                torch.use_deterministic_algorithms(True) and
                CUBLAS_WORKSPACE_CONFIG=:4096:8: 6 steps at B = 2 with
                cuda_decode, a checkpoint every 2 steps (keep 3); run A
                crashes at step 3 and restarts from its newest checkpoint
                with fresh weights, run B runs uninterrupted. Required: A's
                final params and optimizer state bitwise B's, the restored
                state bitwise the in-memory state at step 2, the losses
                after the restart B's, 6 K2 forward and 6 backward launches
                per step; an op that has no deterministic CUDA
                implementation is named instead, and A is then held to B by
                the train phase's gradient rule. Also the store's bytes and
                leaves, snapshot and write ms, step ms with and without a
                write in flight, step ms in deterministic against default
                mode, and A against B in default mode (recorded). The child
                also runs examples/torch_fault_tolerant_train.py (deepseek-7b
                SMOKE, crash at 13 of 24) in deterministic mode
                (``lm_fault_tolerant`` line);
     accuracy — the reference's toy decoder detector (d_model 64, 3 layers x
                24 queries, 64 px) trained on the card for 400 steps at B = 8
                through cuda_decode, then AP (``eval_ap``: 4 batches x 8,
                seed 100) of the exact model and of DEFA (PAP top-6, FWP
                compact 0.6, range narrowing, INT12), each at auto (K1 + K2)
                and through torch_gather, DEFA also served by a
                DetrServeEngine; auto within 0.02 of torch_gather, served
                within 0.02 of detector_apply, exact AP above 0.1; beside
                the reference's 0.271 / 0.228; run in a child process
                (``chip_smoke.py --accuracy``) under deterministic
                algorithms and CUBLAS_WORKSPACE_CONFIG=:4096:8, so that
                the AP is one number per tree;
     lm_train — minitron-4b at its published widths with the depth cut to 2
                layers (bf16): the train step at grad_accum 1 and 2 on one
                data/tokens batch (B 4 x 256), the accum-2 params within a
                stated bf16 limit of accum-1's, then 4 steps whose loss
                must fall; step ms, peak memory, no kernel launched; with
                the lm_fault_tolerant result;
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
     lm_families — every other LM family at published widths, bf16,
                random weights drawn on the card, one model at a time:
                olmoe-1b-7b (MoE, 16 layers), hymba-1.5b (hybrid, 32;
                prompts 37, 128, 300, 1,536) and mamba2-130m (SSM, 24)
                whole, grok-1-314b (MoE) cut to 2 of 64 layers, served by
                the captured ServeEngine (every replayed step's logits
                bitwise the eager run's, greedy tokens equal, K5 at the
                warm-up and the capture only, once per attention layer
                per eager step and per replay from torch.profiler);
                llava-next-34b (vlm) cut to 8 of 60 layers, over 2,880
                stub image embeddings, and whisper-tiny (encdec) whole,
                over stub frames, through api.prefill and 15 eager
                api.decode_step calls; for each, the next step through K5
                against the plain attention (lm_serve's logit limits; a
                token whose set of router picks flipped, first at a
                k-th to (k+1)-th probability gap under 1e-3, is held to
                the median),
                prefill ms per prompt, decode step ms eager and captured,
                idle share, peak memory and the weight bytes a decode
                step reads with their bound; then each family's SMOKE
                config in float32 on the card against the CPU (1e-4);
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
                memories, float32 then int8 table at the config's INT12,
                each frame replayed from the engine's CUDA graphs (build,
                frame, restage, hysteresis, decode): per-frame mode and
                staged against rebuild bytes; every frame's outputs,
                tables, diff reference, EMA and keep states bitwise those
                of an eager engine (capture=False) on the same scenes,
                and again with two sessions admitted mid-stream and a
                reorder (first-call counts flat from the first admission
                on); wrapper launches (the decode graph's warm-up and
                capture only: 2 x 6 K2; eager 6 per frame); per frame from
                torch.profiler for both engines K2 launches (6), graph
                launches, pageable host-to-device copies (0), device
                kernels, busy and idle share; wall clock per frame by
                mode, eager and captured (median, p10, p90; frames that
                capture apart); graph pool bytes, peak memory; outputs
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
     distributed — the distributed port on this card through in-process
                ranks (``distributed.collectives.run_in_process``) at full
                width: deformable-DETR-DEFA's band-sharded encoder (800 x
                1333 pyramid, B = 2) at 2 and 4 bands, one float32 block
                against ``encoder_apply`` (torch_gather, FWP off; 2e-4)
                and the six-block bf16 stack with and without INT12
                against ``encoder_apply`` on the same padded pyramid
                (median in bf16 steps and max |error| against stated
                limits), the bytes a rank
                hands the collectives per block and image against the
                reference's formula (exact), the banded and one-band
                stacks' wall time; olmoe-1b-7b's MoE layer under expert
                parallelism at tp 2 and 4 against the local moe_apply;
                the compressed psum over 4 ranks. Then a world of one NCCL
                rank (``chip_smoke.py --dist-rank`` in a child) and, with
                2 or more cards, one rank per card up to 4: the banded
                layer against one card, the sharded minitron-4b train
                step (2 layers, bf16) against the single-card step and
                the time of its first and second call, the
                trained state resharded onto another mesh and a state
                through the checkpoint store (bitwise), the compressed
                psum against the same ranks in-process (bitwise) and, on
                2 or more ranks, EP over the wire; K1-K5 are not on this
                path (their launch counts are recorded, 0);
     tp_train — one train step on model-axis shards (in-process ranks):
                deepseek-7b, minitron-8b and olmoe-1b-7b cut in depth,
                gradients per leaf and loss against one card; then
                deformable-detr-defa's serve (6 blocks, auto: K1) and
                train (2 blocks) cells at 800 x 1333, float32, B 2 on
                (data, model) = (1, 4), each rank on its quarter of the
                encoder FFN, against one card's encoder and gradient;
     dryrun   — the port's dry run (``repro_torch.launch.dryrun``): (a)
                fake traces (FakeTensorMode, a fake process group of 256
                ranks, the 16 x 16 mesh) of minitron-4b train_4k,
                olmoe-1b-7b decode_32k under --opt (expert parallel),
                hymba-1.5b long_500k (length-sharded cache),
                deformable-detr-defa serve at auto and its banded cell:
                peak per rank, fits, the three roofline terms, the kernel
                operators called; (b) the DETR serve cell (B = 64, full
                width, auto: K1 6 times) and minitron-4b decode_32k (full
                widths, 2 layers, B = 8: K5) traced fake and run for real
                on a world of one NCCL rank: argument bytes and FLOPs
                equal, the card's peak within 1 % below and 5 % + 256 MiB
                above the fake run's, the median step at or above the
                least time the card could take (arguments read once,
                outputs written once, the token embedding left out; the
                fake roofline is reported beside it), the launches the
                fake run's operator calls; (c)
                the banded cell at 2 bands: bytes per bf16 block and image
                equal the distributed phase's CommStats and the halo
                formula; (d) lm_train's config with remat off, "nothing"
                and "save_comm" (and off again): loss bitwise, gradient
                leaves differing only where the second off run differs,
                the step's peak and ms; the long_500k and DETR cells'
                all-gather bytes beside the parent tree's;
     tp       — serving on model-axis shards (in-process ranks):
                deepseek-7b, minitron-8b and grok-1-314b against one card;
                then hymba-1.5b uncut (bf16, B 1) decoding 4 tokens on
                long_500k's 524,288-slot cache filled from the seed, the
                length split over 4 data ranks (K5's partial mode on each
                rank's slots, the ranks merged in order), tensor parallel
                at tp 2, and both, against one card's decode on the whole
                cache;
  5. times    — each kernel and its plain version on the operands its
                path gave it, their bounds and the library call where one
                exists (K2's backward: the whole call, every kernel it
                launches; K2 also on the 1024 px path's first decoder
                call and on the stream path's int8 staged table), K1's and
                K3's L2 gather bytes, K1 on K3's and on
                K2's operands, the device time of one train step's
                table-gradient chain, one serve forward at B = 2 per path,
                one train step, one LM decode step at B = 4 and one
                512-token prefill, each with its idle share; K5 also on
                hymba-1.5b's first served decode call, and its partial
                mode on a long_500k rank's first call.

    python3 chip_smoke.py --table-grad-chain SRC

times only the table-gradient chain of the train step's first backward
pass, with the port package under ``SRC`` (for example an unpacked
parent commit's ``src``), and prints it as one JSON line.

    python3 chip_smoke.py --host-cost SRC

times, with the port package under ``SRC``, one eager minitron-4b decode
step at B = 4 and one eager 512 px forward at ``auto``, and the host time
per wrapper call of K5 and K1 (run it for two trees in turns).

    python3 chip_smoke.py --dist-world N

runs only the distributed phase's NCCL world of ``N`` ranks, one per
card (to time the sharded step of another tree's package, copy this
script beside that tree's ``src``).

Then the kernel summary line and, last, the contract line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without a CUDA device, or without the repository beside it, the script
exits non-zero before printing any result.
"""
import contextlib
import gc
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
TRAIN_LOOP_STEPS = 6             # train_loop: the full-width detector
TRAIN_LOOP_CKPT_EVERY = 2
TRAIN_LOOP_KEEP = 3
TRAIN_LOOP_FAIL_AT = 3
# DETR's AdamW settings: lr 1e-4, weight decay 1e-4, gradient clip 0.1
DETR_OPT = dict(lr=1e-4, warmup_steps=0, total_steps=400,
                      weight_decay=1e-4, clip_norm=0.1)
TOY_STEPS = 400                  # accuracy: the reference's toy recipe
TOY_BATCH = 8
EVAL_BATCHES = 4                 # eval_ap: 4 batches x 8, seed 100
EVAL_SEED = 100
# the reference's toy AP (EXPERIMENTS.md line 19)
TOY_REFERENCE_AP = {"exact": 0.271, "defa": 0.228}
# examples/detr_serve.py's DEFA_KW: PAP top-6, FWP compact 0.6, range
# narrowing, INT12
DEFA_KW = dict(pap_mode="topk", pap_keep=6, fwp_mode="compact", fwp_k=1.0,
               fwp_capacity=0.6, range_narrow=(8.0, 6.0, 4.0, 3.0),
               act_bits=12, weight_bits=12)
AP_BACKEND_TOL = 0.02            # a near-tie may flip one detection
AP_MIN_EXACT = 0.1               # a model that did not learn fails
LM_TRAIN_LAYERS = 2              # lm_train: minitron-4b's widths, depth cut
LM_TRAIN_BATCH = 4
LM_TRAIN_SEQ = 256
LM_TRAIN_STEPS = 4
LM_TRAIN_LR = 3e-5
# accum 2 against accum 1 on the same batch, before AdamW. The loss is a
# float32 mean either way (7.3e-8 apart on the card); a gradient element
# is a sum over the same tokens rounded to bf16, once in accum 1 and once
# per microbatch in accum 2, so the global norm moves by about bf16's
# unit round-off 2^-8. Forgetting to divide by the microbatch count, or
# dividing twice, moves either by a factor 2.
LM_ACCUM_LOSS_RTOL = 1e-4
LM_ACCUM_GRAD_NORM_RTOL = 2 ** -8
# lm_train, captured vs capture=False after the first step: each later
# step's loss, from states that differ wherever the first step's updates
# did not come out bitwise
LM_STEP_LOSS_RTOL = 1e-3
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
    if not sass["flash_decode"]["UTMALDG"]:
        raise AssertionError("libflash_decode.so lacks its TMA loader: "
                             f"{sass['flash_decode']}")
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
# pass that reads rows element by element, in both dtypes); then the
# served head maps of hymba-1.5b (25 query heads over 5 KV heads at Dh 64:
# in bf16 the tensor-core pass with a block per group of 5, a 1,365-slot
# window; in float32 the CUDA-core pass, groups of 4 and 1) and
# llava-next-34b (56 over 8 at Dh 128: n_rep 7, one block per group in
# bf16, 4 and 3 in float32)
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
            ("unaligned_rows", 4, 24, 8, 128, 4000, 512, "ring"),
            ("hymba_decode", 4, 25, 5, 64, 4096, 512, "ring_window"),
            ("llava_decode", 1, 56, 8, 128, 4096, 512, "ring")]
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
# K5 given the model's head map (label, B, stored KV heads, Dh, W, chunk,
# mask, kv_heads): a tensor-parallel rank of 12 / 3 heads on 4 whose query
# heads straddle two KV groups; minitron-8b's tp-16 rank (2 query heads on
# KV head 5 of the 8 its cache stores, read in place at that offset);
# 6 real query heads padded to 8 over 3 KV heads (the padded ones clamp
# to the last); a map that leaves KV head 1 unread and has a row with no
# valid slot (its V average comes from each head's own KV head); then
# whole GQA groups on the tensor-core pass (bf16): grok-1's 48 query heads
# over 8 KV heads (groups of 6), llava-next-34b's 56 over 8 (groups of 7),
# a run of 17 heads on one KV head (entries of 16 and 1) and a full cache
# of hymba-1.5b's 25 over 5 at a ragged W (the TMA loader's zero-filled
# last tile)
K5_MAP_CASES = [("straddle", 4, 3, 128, 1000, 512, "ring", (0, 1, 1)),
                ("in_place_offset", 4, 8, 128, 1024, 512, "ring", (5, 5)),
                ("padded_heads", 2, 3, 64, 300, 64, "ring_window",
                 (0, 0, 1, 1, 2, 2, 2, 2)),
                ("gap_empty_row", 2, 3, 32, 257, 64, "ring_empty",
                 (2, 2, 2, 0, 0)),
                ("grok_groups", 2, 8, 128, 2048, 512, "ring",
                 tuple(h // 6 for h in range(48))),
                ("llava_groups", 1, 8, 128, 4096, 512, "ring",
                 tuple(h // 7 for h in range(56))),
                ("run_of_17", 2, 2, 64, 1000, 512, "ring_window",
                 (0,) * 17 + (1,) * 3),
                ("hymba_full_ragged", 2, 5, 64, 1000, 512, "full",
                 tuple(h // 5 for h in range(25)))]
# The grouped cases hold a bf16 run to k5_row_tolerance, as the split-edge
# cases do: with 6 to 17 query heads a call has that many more scores that
# may round to the other bf16 neighbour (on an H100, at 17 heads and Dh
# 128, one moved a float32 partial output by 9.3e-5).
K5_GROUPED_CASES = {"grok_groups", "llava_groups", "run_of_17",
                    "hymba_full_ragged", "grok_shards", "run_of_17_shards"}
# K5's partial mode (label, B, Hq, Hkv, Dh, W, mask, shards): the slice's
# decode shape with row 0 empty, split into 4 slot shards (a shard holds no
# valid slot of a row wherever that row's ring has not reached it: its lse
# is -inf and its output zero), each shard's (output, lse) held to the
# plain partial mode and the shards merged in rank order held to the plain
# version on the whole cache; one rank's call of hymba-1.5b's global layer
# on its 131,072 of long_500k's 524,288 slots (4 data ranks, every split
# all valid: the TMA loader); grok-1's groups of 6 over 2 shards with an
# empty row; a run of 17 heads (entries of 16 and 1) on 2 full shards
K5_PARTIAL_CASES = [("slice_4_shards", 4, 24, 8, 128, 4096, "ring_empty", 4),
                    ("hymba_rank", 1, 25, 5, 64, 131072, "full", 1),
                    ("grok_shards", 2, 48, 8, 128, 4096, "ring_empty", 2),
                    ("run_of_17_shards", 2, 17, 1, 64, 2048, "full", 2)]
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


def lse_tolerance(dtype):
    """K5's partial mode, lse against the plain version's: float32 1e-5;
    bf16 2^-7 absolute and relative: a score that rounds to the other
    bf16 neighbour in the two sum orders moves the log-sum-exp by at most
    its rounding step (2^-7 of a score, scaled by 1/sqrt(Dh) < 1)."""
    import torch
    return {"rtol": 2 ** -7, "atol": 2 ** -7} if dtype == torch.bfloat16 \
        else {"rtol": 1e-5, "atol": 1e-5}


def check_partial(name, got, want, dtype, rows=False):
    """K5's partial mode against its plain version: rows with no valid
    slot must be exactly lse -inf and a zero output on both; the others
    within ``tolerance`` (output; with ``rows`` in bf16,
    ``k5_row_tolerance``) and ``lse_tolerance``. Returns the max abs errors
    of output and lse."""
    import torch
    (out, lse), (w_out, w_lse) = got, want
    empty = torch.isneginf(w_lse)
    if not torch.equal(torch.isneginf(lse), empty) \
            or bool(out[empty].any()) or bool(w_out[empty].any()):
        raise AssertionError(f"{name}: rows with no valid slot differ")
    keep = ~empty
    if not bool(keep.any()):                 # a shard no row has a valid slot in
        return 0.0, 0.0
    tol = (k5_row_tolerance(w_out[keep]) if rows and dtype == torch.bfloat16
           else tolerance(dtype, None))
    return (check_close(f"{name} output", out[keep], w_out[keep], tol),
            check_close(f"{name} lse", lse[keep], w_lse[keep],
                        lse_tolerance(dtype)))


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
            table = flash_decode.launch_table(q, k, v)
            length, n_splits = flash_decode.decode_splits(
                b, len(table), 1, w, sm_count(q.device))
            per_split = torch.nn.functional.pad(
                valid, (0, n_splits * length - w)).reshape(b, n_splits, length).any(-1)
            k5.append({"case": case, "pad": flash_decode.chunk_padding(w, chunk),
                       "pass": k5_pass(q, k), "table_entries": len(table),
                       "split_len": length, "splits": n_splits,
                       "rows_without_valid_slot": int((~valid.any(1)).sum()),
                       "empty_splits_in_rows_with_valid_slots":
                           int((~per_split & valid.any(1, keepdim=True)).sum()),
                       "max_abs_err": err})
    for label, b, hkv, dh, w, chunk, mask, kv_heads in K5_MAP_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, valid = k5_operands(gen, b, len(kv_heads), hkv, dh, w,
                                         dtype, mask, device)
            case = f"{label}/{str(dtype)[6:]}"
            want = flash_decode.flash_decode_plain(q, k, v, valid, chunk=chunk,
                                                   kv_heads=kv_heads)
            tol = (k5_row_tolerance(want) if label in K5_GROUPED_CASES
                   and dtype == torch.bfloat16 else tolerance(dtype, None))
            err = check_close(f"flash_decode {case}", flash_decode.flash_decode(
                q, k, v, valid, chunk=chunk, kv_heads=kv_heads), want, tol)
            table = flash_decode.launch_table(q, k, v, kv_heads)
            k5.append({"case": case, "kv_heads": list(kv_heads),
                       "stored_kv_heads": hkv, "pass": k5_pass(q, k),
                       "table_entries": len(table),
                       "split_len": flash_decode.decode_splits(
                           b, len(table), 1, w, sm_count(q.device))[0],
                       "rows_without_valid_slot": int((~valid.any(1)).sum()),
                       "max_abs_err": err})
    for label, b, hq, hkv, dh, w, mask, shards in K5_PARTIAL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, valid = k5_operands(gen, b, hq, hkv, dh, w, dtype, mask,
                                         device)
            case = f"partial/{label}/{str(dtype)[6:]}"
            n = w // shards
            outs, lses, errs, empty = [], [], [], 0
            for r in range(shards):
                part = [t[:, r * n:(r + 1) * n].contiguous()
                        for t in (k, v, valid)]
                got = flash_decode.flash_decode(q, *part[:2], part[2],
                                                partial=True)
                errs.append(check_partial(f"flash_decode {case} shard {r}", got,
                                          flash_decode.flash_decode_plain(
                                              q, *part[:2], part[2],
                                              partial=True), dtype,
                                          rows=label in K5_GROUPED_CASES))
                empty += int(torch.isneginf(got[1]).any(1).sum())
                outs.append(got[0])
                lses.append(got[1])
            want = flash_decode.flash_decode_plain(q, k, v, valid)
            merged = flash_decode.merge_rank_partials(outs, lses, dtype)
            # rows with no valid slot at all: the merge gives zero, the
            # whole cache's normal mode the mean of V (the TPU kernel's)
            whole = valid.any(1)
            tol = (k5_row_tolerance(want[whole]) if dtype == torch.bfloat16
                   else tolerance(dtype, None))
            err = check_close(f"flash_decode {case} merged", merged[whole],
                              want[whole], tol)
            if bool(merged[~whole].any()):
                raise AssertionError(f"flash_decode {case}: a row with no valid "
                                     "slot merged to a non-zero output")
            k5.append({"case": case, "shards": shards, "pass": k5_pass(q, k),
                       "table_entries": len(flash_decode.launch_table(q, k, v)),
                       "shard_rows_without_valid_slot": empty,
                       "rows_without_valid_slot": int((~whole).sum()),
                       "max_abs_err_output": max(e[0] for e in errs),
                       "max_abs_err_lse": max(e[1] for e in errs),
                       "max_abs_err_merged": err})
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
                   "edge cases and the partial mode's merged shards in bf16: "
                   "atol 2^-8 of each (b, h) row's largest |output|; the "
                   "partial mode's lse: f32 1e-5, bf16 2^-7, rows with no "
                   "valid slot exactly -inf with a zero output); matmul: "
                   "atol 2^-20*max(|x|@|w|), bf16 output rtol 2^-7")


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


def gradient_rule(got, want, spread, label):
    """The train phase's gradient rule over two gradient trees (or trees
    proportional to them): median relative difference <= 1e-3 per leaf,
    else <= max(1e-3, 2 x ``spread``'s distance to ``want``, the one-ulp
    spread). A leaf whose exact gradient is 0 carries only float roundoff
    on both sides (the self-attention key bias: it adds the same q.b to
    every logit of a softmax row); its relative differences are noise, so
    it is held in absolute terms, to 1e-6 of the largest gradient.
    Returns the record; raises where the rule fails."""
    g_max = max(float(b.abs().max()) for _, b in leaf_paths(want))
    per_leaf, roundoff, differing = [], [], 0
    for (path, a), (_, b), (_, c) in zip(leaf_paths(got), leaf_paths(want),
                                         leaf_paths(spread)):
        differing += not bool(a.eq(b).all())
        if float(b.abs().max()) <= 1e-6 * g_max:
            roundoff.append({"leaf": path, "max_abs": float(b.abs().max()),
                             "max_abs_diff": float((a - b).abs().max())})
            continue
        per_leaf.append({"leaf": path, "median_rel_diff": median_rel_diff(a, b),
                         "one_ulp_spread": median_rel_diff(c, b)})
    if any(r["max_abs_diff"] > 1e-6 * g_max for r in roundoff):
        raise AssertionError(f"{label}: roundoff-only gradient leaves differ by "
                             f"more than 1e-6 of the largest gradient: {roundoff}")
    rule = "median relative difference <= 1e-3 per leaf"
    bad = [r for r in per_leaf if not r["median_rel_diff"] <= 1e-3]
    if bad:
        rule = "median relative difference <= max(1e-3, 2 x one-ulp spread)"
        bad = [r for r in per_leaf if not r["median_rel_diff"]
               <= max(1e-3, 2 * r["one_ulp_spread"])]
    if bad:
        raise AssertionError(f"{label}: {bad[:8]}")
    return {"rule_held": rule, "leaves": len(per_leaf),
            "bitwise": differing == 0, "differing_leaves": differing,
            "worst_leaves": sorted(per_leaf, key=lambda r: -r["median_rel_diff"])[:8],
            "roundoff_leaves": roundoff, "largest": g_max,
            "max_median_rel_diff": max(r["median_rel_diff"] for r in per_leaf),
            "max_one_ulp_spread": max(r["one_ulp_spread"] for r in per_leaf)}


TRAIN_TIMED_STEPS = 10           # train: wall-clock samples per mode
K2_FWD_KERNEL = "msgs_decode_kernel"
K2_BWD_POINTS = "msgs_decode_bwd_points_kernel"


def train_step_timing(steps, state, batch):
    """For each labelled train step, from ``state`` on ``batch``: wall
    clock over TRAIN_TIMED_STEPS steps (median, p10, p90), device busy
    ms and idle share of one profiled step, and its kernels. Each step
    owns its state; the box keeps the returned one."""
    out = {}
    for label, step in steps.items():
        box = [state]

        def one():
            box[0], _ = step(box[0], batch)
        rec = wall_stats(one, TRAIN_TIMED_STEPS)
        prof = forward_profile(one)
        rec.update(device_busy_ms=prof["device_busy_ms"],
                   profiled_wall_ms=prof["wall_ms"],
                   idle_share=prof["idle_share"],
                   idle_share_at_median=max(0.0, 1 - prof["device_busy_ms"]
                                            / rec["median_ms"]),
                   device_kernels=prof["n_kernels"],
                   top_device=prof["top_device"][:6])
        out[label] = rec
    return out


def phase_train(device):
    """The full-width detector through cuda_decode (K2 forward and
    backward) on the captured step (graphs A and B replayed around the
    Hungarian matcher) and on ``capture=False`` from the same state on the
    same batch: TRAIN_STEPS captured steps, then a replayed step from the
    initial state held to the gradient rule against the eager first step,
    K2 counted inside replays, step
    times both ways; the first step's gradients (eager) against
    torch_gather."""
    import gc
    import torch
    from repro_torch.data.detection import synth_detection_batch
    from repro_torch.kernels import msgs_decode
    from repro_torch.optim.adamw import OptConfig, tree_map
    from repro_torch.train.detr import (detector_api, loss_and_grads,
                                        train_config)
    from repro_torch.train.step import build_train_step, make_train_state

    # slice_config's model with the trainer's routing: torch_gather as the
    # encoder's own backend
    cfg = train_config("deformable-detr-defa", IMG)
    api = detector_api("cuda_decode")
    state0 = make_train_state(cfg, torch.Generator().manual_seed(SEED),
                              device=device, api=api)
    params0 = state0.params
    batch = synth_detection_batch(torch.Generator().manual_seed(SEED),
                                  MAX_BATCH, IMG, cfg.level_shapes,
                                  cfg.n_classes, device=device)
    img = batch[0]
    nudged = (torch.nextafter(img, torch.full_like(img, 2.0)), *batch[1:])
    opt_cfg = OptConfig(**DETR_OPT)
    n_layers = cfg.decoder.n_layers
    clone = lambda tree: tree_map(torch.clone, tree)

    # the eager oracle (capture=False): its first step's moments, its K2
    # backward operands (for the times phase), and the one-ulp spread. The
    # first moments after one step from zero moments are (1 - b1) times
    # the clipped gradients: the gradient rule reads them
    eager = build_train_step(cfg, opt_cfg, api, capture=False)
    with Recorder(msgs_decode, "_backward", n_layers) as rec_b:
        reset_kernel_counts()
        e_state, e_metrics = eager(state0, batch)
        eager_launches = kernel_counts()
    m_eager = clone(e_state.opt["m"])
    spread_step = build_train_step(cfg, opt_cfg, api, capture=False)
    m_spread = clone(spread_step(state0, nudged)[0].opt["m"])
    del spread_step

    # the main path: the captured step
    captured = build_train_step(cfg, opt_cfg, api)
    reset_kernel_counts()
    steps, state = [], state0
    for i in range(TRAIN_STEPS):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, metrics = captured(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        steps.append({"step": i + 1, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "lr": float(metrics["lr"]), "wall_ms": wall,
                      "max_memory_allocated": torch.cuda.max_memory_allocated(),
                      "state_finite": all(bool(torch.isfinite(t).all())
                                          for _, t in leaf_paths(tuple(state)))})
        emit("train_step", **steps[-1])
    launches = kernel_counts()
    want = {"msgs_decode": 2 * n_layers, "msgs_decode_backward": 2 * n_layers,
            "msgs_fused": 0, "msgs_windowed": 0, "matmul": 0, "flash_decode": 0}
    if launches != want or eager_launches != dict(
            want, msgs_decode=n_layers, msgs_decode_backward=n_layers):
        raise AssertionError(
            f"train wrapper launches: captured {launches} (expected {want}: "
            f"warm-up and capture), eager step {eager_launches}")
    if not all(math.isfinite(st["loss"]) and st["state_finite"] for st in steps):
        raise AssertionError(f"non-finite loss or state: {steps}")
    if not steps[-1]["loss"] < steps[0]["loss"]:
        raise AssertionError(f"loss did not fall on the repeated batch: {steps}")

    # captured against eager: the first step from the same state and batch.
    # The captured step's first call was its warm-up, an eager run: the
    # step held here is a replay of graphs A and B, from state0 copied
    # into the standing state
    state, metrics = captured(state0, batch)
    m_captured = clone(state.opt["m"])
    first_metrics = {k: float(v) for k, v in metrics.items()}
    loss_rel = abs(first_metrics["loss"] - float(e_metrics["loss"])) \
        / abs(float(e_metrics["loss"]))
    vs_eager = gradient_rule(m_captured, m_eager, m_spread,
                             "first-step gradients, a replayed captured step "
                             "vs eager")
    vs_eager.update(loss_captured=first_metrics["loss"],
                    loss_eager=float(e_metrics["loss"]), loss_rel_diff=loss_rel,
                    grad_norm_captured=first_metrics["grad_norm"],
                    grad_norm_eager=float(e_metrics["grad_norm"]))
    if not loss_rel <= 1e-3 or int(state.step) != 1:
        raise AssertionError(f"first-step loss, captured vs eager: {vs_eager}")
    del m_captured, m_eager, m_spread

    # K2 inside one replayed step (profiler), graph launches, copies
    box = [state]

    def one():
        box[0], _ = captured(box[0], batch)
    replay = replay_counts(one, (K2_FWD_KERNEL, K2_BWD_POINTS,
                                 "msgs_decode_bwd_table_kernel"))
    if replay["kernels"][K2_FWD_KERNEL] != n_layers \
            or replay["kernels"][K2_BWD_POINTS] != n_layers \
            or replay["cudaGraphLaunch"] != 2 or replay["htod_pageable"]:
        raise AssertionError(f"one replayed train step: {replay}; expected "
                             f"{n_layers} K2 forward and backward launches, "
                             "2 graph launches, no pageable copy")
    host_ms = dict(captured.graphs.host_ms)
    graphs, captures = len(captured.graphs), captured.graphs.captures
    timing = train_step_timing({"captured": captured, "eager": eager},
                               box[0], batch)
    state = box[0]
    del box, one

    dead_grads = loss_and_grads(params0, cfg, batch, backend="cuda_decode")[2]
    dead = [p for p, g in leaf_paths(dead_grads["decoder"])
            if ("/cross/" in p or p.startswith("/value/"))
            and not float(g.abs().sum()) > 0]
    if dead:
        raise AssertionError(f"decoder leaves without gradient: {dead}")
    rerun = bitwise_rerun(params0, cfg, batch, rec_b.calls[0])
    if not rerun["k2_backward_bitwise_equal"]:
        raise AssertionError(f"K2 backward repeated on the same operands is "
                             f"not bitwise equal: {rerun}")

    # the first step's gradients (eager) through torch_gather, and
    # torch_gather's own spread when the input images move by one ulp
    _, _, g_gather = loss_and_grads(params0, cfg, batch, backend="torch_gather")
    _, _, g_spread = loss_and_grads(params0, cfg, nudged, backend="torch_gather")
    vs_gather = gradient_rule(dead_grads, g_gather, g_spread,
                              "first-step gradients, cuda_decode vs torch_gather")
    del dead_grads, g_gather, g_spread
    pool = graph_pool_bytes(captured.graphs)
    del captured, eager, state, e_state
    gc.collect()
    torch.cuda.empty_cache()          # the graphs' pool, before lm_train
    emit("train", model="deformable-detr-defa", img=IMG, batch=MAX_BATCH,
         encoder_backend=cfg.encoder.attn.backend, backend="cuda_decode",
         steps=steps, launches=launches, eager_step_launches=eager_launches,
         per_replayed_step=replay, graph_launches_per_step=replay["cudaGraphLaunch"],
         graphs=graphs, captures=captures, graph_pool_bytes=pool,
         host_matcher_ms=host_ms, step_ms=timing,
         captured_vs_eager=vs_eager, vs_torch_gather=vs_gather, rerun=rerun)
    return {"cfg": cfg, "api": api, "opt_cfg": opt_cfg, "batch": batch,
            "state": state0, "launches": launches, "replay": replay,
            "steps": TRAIN_STEPS, "backward_calls": rec_b.calls}


# --------------------------------------------------------------------------
# phase 4a: train, checkpoint, resume and evaluate
# --------------------------------------------------------------------------

def kernel_counts():
    """Every kernel wrapper's launch counter."""
    from repro_torch.kernels import (flash_decode, matmul, msgs_decode,
                                     msgs_fused, msgs_windowed)
    return {"msgs_fused": msgs_fused.LAUNCHES,
            "msgs_windowed": msgs_windowed.LAUNCHES,
            "msgs_decode": msgs_decode.LAUNCHES,
            "msgs_decode_backward": msgs_decode.LAUNCHES_BWD,
            "matmul": matmul.LAUNCHES, "flash_decode": flash_decode.LAUNCHES}


def reset_kernel_counts():
    from repro_torch.kernels import (flash_decode, matmul, msgs_decode,
                                     msgs_fused, msgs_windowed)
    msgs_fused.LAUNCHES = msgs_windowed.LAUNCHES = 0
    msgs_decode.LAUNCHES = msgs_decode.LAUNCHES_BWD = 0
    matmul.LAUNCHES = flash_decode.LAUNCHES = 0


def counts_since(before):
    return {k: v - before[k] for k, v in kernel_counts().items()}


def tree_diff(a, b):
    """Leaf by leaf over two train states: bitwise equal or not, the
    largest |a - b| and the largest per-leaf median relative difference."""
    import torch
    pa, pb = leaf_paths(tuple(a)), leaf_paths(tuple(b))
    if [p for p, _ in pa] != [p for p, _ in pb]:
        raise AssertionError("train states of different structure")
    differ = []
    for (path, x), (_, y) in zip(pa, pb):
        if x.dtype != y.dtype or not torch.equal(x, y):
            rel = median_rel_diff(x, y) if x.is_floating_point() else math.inf
            differ.append((path, float((x.double() - y.double()).abs().max()),
                           rel))
    return {"bitwise": not differ, "leaves": len(pa),
            "differing_leaves": len(differ),
            "max_abs_diff": max((d for _, d, _ in differ), default=0.0),
            "max_median_rel_diff": max((r for _, _, r in differ), default=0.0),
            "differing_leaf_paths": [p for p, _, _ in differ[:8]]}


def nondeterministic_op(err):
    """The op named by torch's refusal under use_deterministic_algorithms,
    or None for any other error."""
    msg = str(err)
    marker = " does not have a deterministic implementation"
    return msg.split(marker)[0].strip() if marker in msg else None


def under_determinism(fn):
    """``fn()`` with ``torch.use_deterministic_algorithms(True)``. If an op
    of it has no deterministic CUDA implementation, the flag makes it
    raise: then ``fn()`` again with ``warn_only=True``. Returns (result,
    the refused op or None)."""
    import torch
    torch.use_deterministic_algorithms(True)
    try:
        return fn(), None
    except RuntimeError as err:
        op = nondeterministic_op(err)
        if op is None:
            raise
    torch.use_deterministic_algorithms(True, warn_only=True)
    return fn(), op


def step_ms(rows, skip_first=True):
    ms = [r["wall_ms"] for r in rows if not (skip_first and r["step"] == 0)]
    return {"median": statistics.median(ms), "n": len(ms)} if ms else None


def detector_train_runs(device, root):
    """The full-width detector through train_loop on captured steps: run A
    crashes at step TRAIN_LOOP_FAIL_AT and restarts in the same process
    from its newest checkpoint with fresh weights, through the same step
    (which copies the restored state into its standing state); run B runs
    uninterrupted on a step of its own, run C as B with ``capture=False``.
    Each step's wrapper launches, copies of the in-memory state at the
    first checkpoint and of the state the restart restored are kept."""
    import torch
    from repro_torch.optim.adamw import OptConfig, tree_map
    from repro_torch.train import detr
    from repro_torch.train.loop import (FailureInjector, SimulatedNodeFailure,
                                        TrainLoopConfig, train_loop)
    from repro_torch.train.step import (TrainState, build_train_step,
                                        make_train_state)
    cfg = detr.train_config("deformable-detr-defa", IMG)
    opt_cfg = OptConfig(**DETR_OPT)
    loop_cfg = TrainLoopConfig(total_steps=TRAIN_LOOP_STEPS,
                               ckpt_every=TRAIN_LOOP_CKPT_EVERY,
                               keep_ckpts=TRAIN_LOOP_KEEP, log_every=1)
    batches = detr.detection_batches(cfg, MAX_BATCH, SEED, device)
    api = detr.detector_api("cuda_decode")
    fresh = lambda seed: make_train_state(
        cfg, torch.Generator().manual_seed(seed), device=device, api=api)
    snapshot = lambda st: TrainState(*tree_map(torch.clone, tuple(st)))
    per_step, seen = [], {}

    def counted(base):
        def step(state, batch):
            before = kernel_counts()
            new, metrics = base(state, batch)
            per_step.append(counts_since(before))
            return new, metrics
        return step
    base_a = build_train_step(cfg, opt_cfg, api)
    step_a = counted(base_a)

    def run_a(state, batch):
        new, metrics = step_a(state, batch)
        if int(new.step) == TRAIN_LOOP_CKPT_EVERY:
            seen["in_memory"] = snapshot(new)
        return new, metrics

    def restarted(state, batch):
        if "restored" not in seen:
            seen["restored"] = snapshot(state)
        return step_a(state, batch)

    quiet = lambda s: None
    ckpt = str(Path(root) / "run_a")
    try:
        train_loop(fresh(SEED), run_a, batches, loop_cfg, ckpt_dir=ckpt,
                   injector=FailureInjector(TRAIN_LOOP_FAIL_AT), log=quiet)
    except SimulatedNodeFailure:
        pass
    else:
        raise AssertionError("run A: no failure was injected")
    from repro_torch.checkpoint.store import latest_step
    crashed_at = latest_step(ckpt)
    # the restart draws other weights: the checkpoint must replace them
    a_state, a_stats = train_loop(fresh(SEED + 1), restarted, batches,
                                  loop_cfg, ckpt_dir=ckpt, log=quiet)
    final = Path(ckpt) / f"step_{TRAIN_LOOP_STEPS:08d}"
    manifest = json.loads((final / "manifest.json").read_text())
    store = {"leaves": len(manifest["leaves"]),
             "bytes": sum(f.stat().st_size for f in final.glob("*.npy")),
             "kept": sorted(p.name for p in Path(ckpt).iterdir())}
    b_state, b_stats = train_loop(fresh(SEED), counted(build_train_step(
        cfg, opt_cfg, api)), batches, loop_cfg, ckpt_dir=None, log=quiet)
    c_state, c_stats = train_loop(fresh(SEED), build_train_step(
        cfg, opt_cfg, api, capture=False), batches, loop_cfg, ckpt_dir=None,
        log=quiet)
    return {"a": a_state, "a_stats": a_stats, "b": b_state,
            "b_stats": b_stats, "c": c_state, "c_stats": c_stats,
            "per_step": per_step, "seen": seen,
            "host_matcher_ms": dict(base_a.graphs.host_ms),
            "crashed_at_ckpt": crashed_at, "store": store,
            "layers": cfg.decoder.n_layers}


def step_profiles(device, op):
    """One full-width detector train step (train_loop's), captured and
    eager (``capture=False``), profiled by torch.profiler under
    determinism (warn_only where an op was refused) and in default mode:
    each one's wall and device busy ms, top kernels and graph launches,
    and the kernels whose device time grows most under determinism (the
    captured step). Leaves determinism off."""
    import torch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import detr
    from repro_torch.train.step import build_train_step, make_train_state
    cfg = detr.train_config("deformable-detr-defa", IMG)
    api = detr.detector_api("cuda_decode")
    state = make_train_state(cfg, torch.Generator().manual_seed(SEED),
                             device=device, api=api)
    batch = detr.detection_batches(cfg, MAX_BATCH, SEED, device)(0)
    out, by_op = {}, {}
    for mode, flag in (("deterministic", True), ("default", False)):
        torch.use_deterministic_algorithms(
            flag, warn_only=flag and op is not None)
        for capture in (True, False):
            step = build_train_step(cfg, OptConfig(**DETR_OPT), api,
                                    capture=capture)
            dev, cpu, wall = profile(lambda: step(state, batch))
            label = f"{mode}/{'captured' if capture else 'eager'}"
            by_op[label] = {}
            for e in dev:
                ms, n = by_op[label].get(e.key[:90], (0.0, 0))
                by_op[label][e.key[:90]] = (ms + _device_us(e) / 1e3,
                                            n + e.count)
            busy = sum(ms for ms, _ in by_op[label].values())
            top = sorted(by_op[label].items(), key=lambda kv: -kv[1][0])[:6]
            out[label] = {
                "wall_ms": wall, "device_busy_ms": busy,
                "idle_share": max(0.0, 1 - busy / wall) if wall else None,
                "cudaGraphLaunch": sum(e.count for e in cpu
                                       if "cudaGraphLaunch" in e.key),
                "top_device": [{"op": k, "count": n, "ms": ms}
                               for k, (ms, n) in top]}
            del step
    det, dft = by_op["deterministic/captured"], by_op["default/captured"]
    grow = {k: det.get(k, (0.0, 0))[0] - dft.get(k, (0.0, 0))[0]
            for k in set(det) | set(dft)}
    out["grows_most"] = [
        {"op": k, "deterministic_ms": det.get(k, (0.0, 0))[0],
         "deterministic_count": det.get(k, (0.0, 0))[1],
         "default_ms": dft.get(k, (0.0, 0))[0],
         "default_count": dft.get(k, (0.0, 0))[1]}
        for k in sorted(grow, key=lambda k: -grow[k])[:6]]
    return out


def check_detector_runs(runs, op, label):
    """The train_loop contract on one mode's runs: wrapper launches only at
    each step's first call (warm-up and capture: 2 x 6 K2 forward and
    backward, no K1, K3; the restart replays run A's graphs), the restored
    state bitwise the in-memory state at the checkpoint, A against B and
    B (captured) against C (eager): bitwise and the same losses when no
    op was refused, else the train phase's gradient rule (median relative
    1e-3 per leaf) and losses to 1e-3."""
    n = runs["layers"]
    first = {"msgs_fused": 0, "msgs_windowed": 0, "msgs_decode": 2 * n,
             "msgs_decode_backward": 2 * n, "matmul": 0, "flash_decode": 0}
    later = dict.fromkeys(first, 0)
    a_steps = TRAIN_LOOP_FAIL_AT + TRAIN_LOOP_STEPS - TRAIN_LOOP_CKPT_EVERY
    want = [first] + [later] * (a_steps - 1) + [first] \
        + [later] * (TRAIN_LOOP_STEPS - 1)
    if runs["per_step"] != want:
        raise AssertionError(f"{label}: per-step launches {runs['per_step']}; "
                             f"expected {want}")
    if runs["crashed_at_ckpt"] != TRAIN_LOOP_CKPT_EVERY \
            or runs["a_stats"]["start"] != TRAIN_LOOP_CKPT_EVERY:
        raise AssertionError(f"{label}: restart from {runs['a_stats']['start']}"
                             f", newest checkpoint {runs['crashed_at_ckpt']}")
    restore = tree_diff(runs["seen"]["restored"], runs["seen"]["in_memory"])
    if not restore["bitwise"]:
        raise AssertionError(f"{label}: restored state is not the in-memory "
                             f"state at step {TRAIN_LOOP_CKPT_EVERY}: {restore}")
    a_vs_b = tree_diff(runs["a"], runs["b"])
    b_vs_c = tree_diff(runs["b"], runs["c"])
    after = runs["b_stats"]["losses"][TRAIN_LOOP_CKPT_EVERY:]
    losses = runs["a_stats"]["losses"]
    b_losses, c_losses = runs["b_stats"]["losses"], runs["c_stats"]["losses"]
    if not all(math.isfinite(x) for x in losses + b_losses + c_losses):
        raise AssertionError(f"{label}: non-finite loss {losses}")
    if op is None:
        rule = "bitwise"
        ok = a_vs_b["bitwise"] and losses == after
        captured_ok = b_vs_c["bitwise"] and b_losses == c_losses
    else:
        rule = "median relative difference <= 1e-3 per leaf, losses rtol 1e-3"
        close = lambda xs, ys: all(abs(x - y) <= 1e-3 * abs(y)  # noqa: E731
                                   for x, y in zip(xs, ys))
        ok = a_vs_b["max_median_rel_diff"] <= 1e-3 and close(losses, after)
        captured_ok = b_vs_c["max_median_rel_diff"] <= 1e-3 \
            and close(b_losses, c_losses)
    return {"rule": rule, "held": ok and captured_ok,
            "restart_held": ok, "captured_vs_eager_held": captured_ok,
            "restored_vs_in_memory": restore, "a_vs_b": a_vs_b,
            "captured_vs_eager": b_vs_c,
            "losses_after_restart": losses,
            "losses_uninterrupted": b_losses, "losses_eager": c_losses}


def train_loop_child(device):
    """``chip_smoke.py --train-loop``: run in a child process, so that the
    deterministic-algorithms flag and CUBLAS_WORKSPACE_CONFIG reach no
    other phase. Prints the ``train_loop`` and ``lm_fault_tolerant``
    lines; raises on a failed requirement."""
    import importlib.util
    import torch
    t0 = time.perf_counter()
    reset_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        # each attempt writes its checkpoints into a directory of its own
        runs, op = under_determinism(
            lambda: detector_train_runs(device, tempfile.mkdtemp(dir=tmp)))
        det = check_detector_runs(runs, op, "deterministic mode")
        spec = importlib.util.spec_from_file_location(
            "torch_fault_tolerant_train", Path(__file__).resolve().parent
            / "examples" / "torch_fault_tolerant_train.py")
        demo = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(demo)
        ft_s = {}
        for capture in (True, False):
            t_ft = time.perf_counter()
            res = under_determinism(
                lambda: demo.run(device, log=lambda s: None, capture=capture))
            ft_s["captured" if capture else "eager"] = \
                time.perf_counter() - t_ft
            if capture:
                ft, ft_op = res
            else:
                ft_eager = res[0]
        profiles = step_profiles(device, op)
        default = detector_train_runs(device, Path(tmp) / "default")
    if not det["held"]:
        raise AssertionError(f"train_loop, deterministic mode: {det}")
    a_rows = runs["a_stats"]["history"]
    in_flight = [r for r in a_rows if r["write_in_flight"]]
    idle = [r for r in a_rows if not r["write_in_flight"]]
    a_stats = runs["a_stats"]
    default_diff = tree_diff(default["a"], default["b"])
    emit("train_loop", model="deformable-detr-defa", img=IMG, batch=MAX_BATCH,
         backend="cuda_decode", steps=TRAIN_LOOP_STEPS,
         ckpt_every=TRAIN_LOOP_CKPT_EVERY, keep=TRAIN_LOOP_KEEP,
         fail_at=TRAIN_LOOP_FAIL_AT,
         cublas_workspace_config=os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
         nondeterministic_op=op,
         restart_bitwise_on_card=op is None and det["held"],
         deterministic=det,
         launches_per_step=runs["per_step"][0], steps_counted=len(runs["per_step"]),
         store=runs["store"],
         snapshot_ms=[s * 1e3 for s in a_stats["snapshot_s"]],
         write_ms=[s * 1e3 for s in a_stats["write_s"]],
         step_ms_restarted_run=[r["wall_ms"] for r in a_rows],
         step_ms_write_in_flight=step_ms(in_flight),
         step_ms_no_write_in_flight=step_ms(idle),
         step_ms_deterministic=step_ms(runs["b_stats"]["history"]),
         step_ms_deterministic_eager=step_ms(runs["c_stats"]["history"]),
         step_ms_default=step_ms(default["b_stats"]["history"]),
         step_ms_default_eager=step_ms(default["c_stats"]["history"]),
         host_matcher_ms=runs["host_matcher_ms"],
         step_profile=profiles,
         # reported, not held: in default mode two runs of one captured
         # step (a_vs_b) part as far as captured and eager do over the
         # steps; the train phase holds a replayed step against eager
         default_mode={"rule": "none (reported)", "a_vs_b": default_diff,
                       "captured_vs_eager": tree_diff(default["b"],
                                                      default["c"]),
                       "losses_after_restart": default["a_stats"]["losses"],
                       "losses_uninterrupted": default["b_stats"]["losses"],
                       "losses_eager": default["c_stats"]["losses"]},
         seconds=time.perf_counter() - t0)
    ft_diff = tree_diff(ft["restarted"], ft["reference"])
    ft_vs_eager = tree_diff(ft["restarted"], ft_eager["restarted"])
    ft_after = ft["losses_reference"][ft["resumed_from"]:]
    if ft_op is None:
        ft_rule = "bitwise"
        ft_ok = ft_diff["bitwise"] and ft["losses_restarted"] == ft_after \
            and ft_vs_eager["bitwise"] \
            and ft["losses_restarted"] == ft_eager["losses_restarted"]
    else:
        ft_rule = "max |delta| <= 1e-5 (the demo's own limit)"
        ft_ok = ft_diff["max_abs_diff"] <= 1e-5 \
            and ft_vs_eager["max_abs_diff"] <= 1e-5
    emit("lm_fault_tolerant", model="deepseek-7b SMOKE", steps=24,
         fail_at=13, resumed_from=ft["resumed_from"], nondeterministic_op=ft_op,
         rule=ft_rule, held=ft_ok, restarted_vs_uninterrupted=ft_diff,
         captured_vs_eager=ft_vs_eager,
         final_loss=ft["losses_reference"][-1], seconds=ft_s)
    if not ft_ok:
        raise AssertionError(f"fault-tolerant LM demo: {ft_diff}, captured "
                             f"vs eager {ft_vs_eager}")


def phase_train_loop():
    """Runs ``--train-loop`` in a child process under
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` and relays its lines; returns
    them by phase."""
    t0 = time.perf_counter()
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--train-loop"], env=env, capture_output=True,
                          text=True, timeout=900)
    lines = {}
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if line.startswith("{"):
            rec = json.loads(line)
            lines[rec.get("phase")] = rec
    if proc.returncode != 0 or not {"train_loop", "lm_fault_tolerant"} <= set(lines):
        sys.stderr.write(proc.stderr[-6000:])
        raise AssertionError(f"--train-loop child exited {proc.returncode}")
    lines["seconds"] = time.perf_counter() - t0
    return lines


def eval_images(cfg, device):
    """The images and gt of eval_ap's batches (seed 100), drawn on the
    device as eval_ap draws them."""
    from repro_torch.data import fold_in
    from repro_torch.data.detection import synth_detection_batch
    return [synth_detection_batch(fold_in(EVAL_SEED, i), TOY_BATCH,
                                  cfg.img_size, cfg.level_shapes,
                                  cfg.n_classes, device=device)
            for i in range(EVAL_BATCHES)]


def served_ap(cfg, params, device):
    """AP from a DetrServeEngine's cls_probs on eval_ap's images, as
    examples/detr_serve.py computes it (log of the clipped probabilities
    through eval_detection_ap). The launches counted are the engine's
    warm-up and capture: on the card every served batch is a replay."""
    import numpy as np
    from repro_torch.data.detection import eval_detection_ap
    from repro_torch.serve import DetrRequest, DetrServeEngine
    batches = eval_images(cfg, device)
    before = kernel_counts()
    with DetrServeEngine(cfg, params, max_batch=TOY_BATCH, backend="auto",
                         device=device) as engine:
        describe = engine.describe()
        reqs = []
        for i, (img, _, _, _) in enumerate(batches):
            host = img.cpu().numpy()
            for b in range(TOY_BATCH):
                reqs.append(DetrRequest(rid=i * TOY_BATCH + b, image=host[b]))
                if not engine.submit(reqs[-1]):
                    raise AssertionError(f"request rejected: {reqs[-1].error}")
        engine.run_until_drained()
        launches = counts_since(before)
    aps = []
    for i, (_, _, _, gt) in enumerate(batches):
        rs = reqs[i * TOY_BATCH:(i + 1) * TOY_BATCH]
        logp = np.log(np.clip(np.stack([r.cls_probs for r in rs]), 1e-9, None))
        aps.append(eval_detection_ap(logp, np.stack([r.boxes for r in rs]), gt,
                                     n_classes=cfg.n_classes))
    return float(np.mean(aps)), describe, launches


def toy_replay(cfg, device):
    """One replayed step of the toy trainer's captured step (a step of
    its own, from the toy's initial state): K2 and graph launches and
    host-to-device copies from the profiler."""
    import torch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train import detr
    from repro_torch.train.step import build_train_step, make_train_state
    tcfg = detr.with_attn(cfg, backend=detr.TRAIN_ENCODER_BACKEND)
    api = detr.detector_api("cuda_decode")
    step = build_train_step(tcfg, OptConfig(lr=2e-3, warmup_steps=10,
                                            total_steps=TOY_STEPS,
                                            weight_decay=0.0), api)
    box = [make_train_state(tcfg, torch.Generator().manual_seed(SEED),
                            device=device, api=api)]
    batch = detr.detection_batches(tcfg, TOY_BATCH, SEED, device)(0)

    def one():
        box[0], _ = step(box[0], batch)
    return replay_counts(one, (K2_FWD_KERNEL, K2_BWD_POINTS))


def phase_accuracy(device):
    """The reference's toy decoder detector trained on the card through
    cuda_decode (K2 both ways), then AP for the exact model and for DEFA,
    each at auto (K1 + K2) and through torch_gather; DEFA also served by
    a DetrServeEngine."""
    import torch
    from repro_torch.train import detr
    t0 = time.perf_counter()
    cfg = detr.toy_decoder_config()
    defa = detr.with_attn(cfg, **DEFA_KW)
    reset_kernel_counts()
    t_train = time.perf_counter()
    state, stats = detr.train_toy(cfg, TOY_STEPS, TOY_BATCH, SEED,
                                  backend="cuda_decode", device=device,
                                  log=lambda s: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t_train
    train_launches = kernel_counts()
    n_layers, n_blocks = cfg.decoder.n_layers, cfg.encoder.n_blocks
    # the step is captured: its wrappers run at the warm-up and the capture
    want = {"msgs_fused": 0, "msgs_windowed": 0,
            "msgs_decode": 2 * n_layers, "msgs_decode_backward": 2 * n_layers,
            "matmul": 0, "flash_decode": 0}
    if train_launches != want:
        raise AssertionError(f"toy training launches {train_launches}; "
                             f"expected {want}")
    replay = toy_replay(cfg, device)
    if replay["kernels"][K2_FWD_KERNEL] != n_layers \
            or replay["kernels"][K2_BWD_POINTS] != n_layers \
            or replay["cudaGraphLaunch"] != 2 or replay["htod_pageable"]:
        raise AssertionError(f"one replayed toy step: {replay}")
    params = state.params
    aps, per_forward = {}, {}
    for name, c in (("exact", cfg), ("defa", defa)):
        for backend in ("auto", "torch_gather"):
            reset_kernel_counts()
            aps[f"{name}/{backend}"] = detr.eval_ap(
                c, params, EVAL_BATCHES, TOY_BATCH, EVAL_SEED, backend=backend)
            per_forward[f"{name}/{backend}"] = {
                k: v / EVAL_BATCHES for k, v in kernel_counts().items() if v}
    for name in ("exact", "defa"):
        if per_forward[f"{name}/auto"] != {"msgs_fused": n_blocks,
                                           "msgs_decode": n_layers} \
                or per_forward[f"{name}/torch_gather"]:
            raise AssertionError(f"{name}: kernel launches per evaluation "
                                 f"forward {per_forward}")
    ap_served, describe, served_launches = served_ap(defa, params, device)
    delta = {name: abs(aps[f"{name}/auto"] - aps[f"{name}/torch_gather"])
             for name in ("exact", "defa")}
    served_delta = abs(ap_served - aps["defa/auto"])
    exact, ap_defa = aps["exact/auto"], aps["defa/auto"]
    emit("accuracy", model="toy decoder detector", config={
        "d_model": 64, "heads": 4, "levels": 4, "points": 4,
        "encoder_blocks": n_blocks, "d_ffn": 128, "img": cfg.img_size,
        "classes": cfg.n_classes, "backbone": cfg.backbone_width,
        "decoder_layers": n_layers, "queries": cfg.decoder.n_queries},
        defa_knobs=DEFA_KW, train_steps=TOY_STEPS, train_batch=TOY_BATCH,
        train_backend="cuda_decode", train_seconds=train_s,
        train_captured=True, replayed_step=replay,
        first_loss=stats["losses"][0], final_loss=stats["losses"][-1],
        train_launches=train_launches, ap=aps, ap_exact=exact,
        ap_defa=ap_defa, ap_delta=ap_defa - exact,
        reference_ap=TOY_REFERENCE_AP,
        reference_delta=TOY_REFERENCE_AP["defa"] - TOY_REFERENCE_AP["exact"],
        auto_vs_torch_gather=delta, ap_served_defa=ap_served,
        served_vs_detector_apply=served_delta, served_plan=describe,
        served_launches=served_launches,
        launches_per_eval_forward=per_forward,
        seconds=time.perf_counter() - t0)
    if not all(d <= AP_BACKEND_TOL for d in delta.values()) \
            or served_delta > AP_BACKEND_TOL or not exact > AP_MIN_EXACT:
        raise AssertionError(
            f"accuracy: auto vs torch_gather {delta}, served vs detector_apply "
            f"{served_delta} (limit {AP_BACKEND_TOL}), exact AP {exact} "
            f"(must exceed {AP_MIN_EXACT})")


def lm_train_config():
    import dataclasses
    return dataclasses.replace(lm_config(), n_layers=LM_TRAIN_LAYERS)


def accum_agreement(p1, p2, lr):
    """An extra check beside the loss and grad_norm rule: AdamW's first
    step moves each element by at most lr whatever the gradient (so this
    cannot see the gradient's scale). Gradients accumulated in two
    float32 halves and in one bf16 pass can differ in sign where they are
    near 0, which moves an element by up to 2 lr, and p - lr u then
    rounds to bf16 (at most 2^-7 |p|). Rule: every element within
    2 lr + 2^-7 |p|, and at most 1 % of the elements differing at all."""
    import torch
    worst, n_diff, n = 0.0, 0, 0
    for (path, a), (_, b) in zip(leaf_paths(p1), leaf_paths(p2)):
        a32, b32 = a.float(), b.float()
        err = (a32 - b32).abs()
        limit = 2 * lr + 2 ** -7 * b32.abs()
        worst = max(worst, float((err / limit).max()))
        n_diff += int((err > 0).sum())
        n += err.numel()
    return {"max_err_over_limit": worst, "differing_share": n_diff / n,
            "elements": n, "held": worst <= 1.0 and n_diff <= 0.01 * n}


def lm_params_copy(state):
    return [t.clone() for _, t in leaf_paths(state.params)]



def phase_lm_train(device, fault_tolerant):
    """minitron-4b at its published widths, depth cut to LM_TRAIN_LAYERS,
    bf16, remat on: the train step at grad_accum 2 and 1 on the same
    first batch (a captured step's first call is its warm-up: the step
    compared is its replay from the same initial state), the captured
    step against ``capture=False`` on it and on each later step's loss, then
    LM_TRAIN_STEPS - 1 more steps each way on data/tokens batches (step
    times, idle share, graph launches, the graph pool); no kernel wrapper
    runs (the reference trains through plain jnp). One step object and
    its standing state (17 GB) live at a time, each dropped with its
    graphs before the next."""
    import dataclasses
    import gc
    import torch
    from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import build_train_step, make_train_state
    t0 = time.perf_counter()
    cfg = lm_train_config()
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=LM_TRAIN_SEQ,
                           global_batch=LM_TRAIN_BATCH, seed=SEED)
    # AdamW's first steps move every element by about lr (the update is
    # the gradient's sign): at 3072 wide an lr of 1e-4 or more first raises
    # the loss (1.2e-3 took it from 13.0 to 22.5 on the card); 3e-5 lowers
    # it, though in bf16 it moves only weights under 2^-7 in magnitude
    lr = LM_TRAIN_LR
    opt_cfg = OptConfig(lr=lr, warmup_steps=0, total_steps=LM_TRAIN_STEPS)
    batches = [synth_token_batch(data, i, device=device)
               for i in range(LM_TRAIN_STEPS)]

    def drop():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    drop()
    torch.cuda.reset_peak_memory_stats()
    reset_kernel_counts()
    # the initial state is drawn from the seed for each step object
    initial = lambda: make_train_state(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    first = {}
    for label, c, capture in (("accum2", dataclasses.replace(cfg, grad_accum=2),
                               True),
                              ("eager", cfg, False), ("captured", cfg, True)):
        step = build_train_step(c, opt_cfg, capture=capture)
        if capture:
            # the first call is the warm-up (an eager run) and the capture:
            # the step held below is a replay from the same initial state
            step(initial(), batches[0])
            drop()
        state, m = step(initial(), batches[0])
        torch.cuda.synchronize()
        metrics = {k: float(m[k]) for k in ("loss", "grad_norm", "lr")}
        if label == "captured":        # against the two kept copies
            got = [t for _, t in leaf_paths(state.params)]
            first[label] = (metrics, None)
            agree = {k: accum_agreement(first[k][1], got, metrics["lr"])
                     for k in ("accum2", "eager")}
            agree["eager"]["bitwise"] = metrics == first["eager"][0] and all(
                torch.equal(a, b) for a, b in zip(first["eager"][1], got))
            del got
            first["accum2"], first["eager"] = ((first[k][0], None) + first[k][2:]
                                               for k in ("accum2", "eager"))
            drop()
        else:
            first[label] = (metrics, lm_params_copy(state))
        if label == "accum2":
            n_params = sum(t.numel() for t in first[label][1])
            del step, state, m
            drop()
            continue
        losses, wall = [first[label][0]["loss"]], []
        for batch in batches[1:]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            wall.append((time.perf_counter() - t) * 1e3)
        box = [state]

        def one():
            box[0], _ = step(box[0], batches[-1])
        prof = forward_profile(one)
        rec = {"losses": losses, "step_ms": wall,
               "step_ms_median": statistics.median(wall),
               "device_busy_ms": prof["device_busy_ms"],
               "profiled_wall_ms": prof["wall_ms"],
               "idle_share": prof["idle_share"],
               "idle_share_at_median": max(0.0, 1 - prof["device_busy_ms"]
                                           / statistics.median(wall)),
               "device_kernels": prof["n_kernels"],
               "top_device": prof["top_device"][:6]}
        if capture:
            rec["per_replayed_step"] = replay_counts(one, ())
            rec["graph_pool_bytes"] = graph_pool_bytes(step.graphs)
            rec["graphs"] = len(step.graphs)
        first[label] = first[label] + (rec,)
        del step, state, m, box, one
        drop()
    peak = torch.cuda.max_memory_allocated()
    launches = kernel_counts()
    (accum2, _), (eager1, _, eager_rec), (accum1, _, cap_rec) = (
        first["accum2"], first["eager"], first["captured"])
    accum = agree["accum2"]
    rel = {k: abs(accum2[k] - accum1[k]) / abs(accum1[k])
           for k in ("loss", "grad_norm")}
    accum.update(accum1=accum1, accum2=accum2, rel_diff=rel,
                 rtol={"loss": LM_ACCUM_LOSS_RTOL,
                       "grad_norm": LM_ACCUM_GRAD_NORM_RTOL})
    accum["held"] = (accum["held"] and rel["loss"] <= LM_ACCUM_LOSS_RTOL
                     and rel["grad_norm"] <= LM_ACCUM_GRAD_NORM_RTOL)
    # the captured step against capture=False, held to the same rules
    vs_eager = agree["eager"]
    rel_e = {k: abs(eager1[k] - accum1[k]) / abs(eager1[k])
             for k in ("loss", "grad_norm")}
    step_rel = [abs(a - b) / abs(b) for a, b in zip(cap_rec["losses"],
                                                     eager_rec["losses"])]
    vs_eager.update(captured=accum1, eager=eager1, rel_diff=rel_e,
                    later_losses_rel_diff=step_rel[1:],
                    later_losses_rtol=LM_STEP_LOSS_RTOL)
    vs_eager["held"] = (vs_eager["held"] and rel_e["loss"] <= LM_ACCUM_LOSS_RTOL
                        and rel_e["grad_norm"] <= LM_ACCUM_GRAD_NORM_RTOL
                        and max(step_rel[1:]) <= LM_STEP_LOSS_RTOL)
    losses = cap_rec["losses"]
    emit("lm_train", model=LM_ARCH, reduced={"n_layers": [lm_config().n_layers,
                                                          LM_TRAIN_LAYERS]},
         d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
         head_dim=cfg.dh, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         dtype=str(cfg.dtype), remat=cfg.remat, params=n_params,
         batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ, lr=lr, losses=losses,
         accum2_vs_accum1=accum, captured_vs_eager=vs_eager,
         step_ms=cap_rec["step_ms"], step_ms_median=cap_rec["step_ms_median"],
         captured=cap_rec, eager=eager_rec,
         max_memory_allocated=peak, launches=launches,
         fault_tolerant=fault_tolerant, seconds=time.perf_counter() - t0)
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"lm_train: losses {losses}")
    if not accum["held"]:
        raise AssertionError(f"lm_train: accum 2 vs accum 1 {accum}")
    if not vs_eager["held"]:
        raise AssertionError(f"lm_train: captured vs eager {vs_eager}")
    if cap_rec["per_replayed_step"]["cudaGraphLaunch"] != 1 \
            or cap_rec["per_replayed_step"]["htod_pageable"]:
        raise AssertionError(f"lm_train: one replayed step "
                             f"{cap_rec['per_replayed_step']}")
    if any(launches.values()):
        raise AssertionError(f"lm_train launched kernels: {launches}")


# --------------------------------------------------------------------------
# phase 4b: serve the full-width dense LM
# --------------------------------------------------------------------------

def lm_config():
    from repro_torch.configs import get_config
    return get_config(LM_ARCH)


def seeded_prompts(vocab, lengths=LM_PROMPTS):
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lengths]


class PlainAttention:
    """Inside the block, the decoder's decode attention takes K5's plain
    version on the card (``ops.flash_decode`` swapped in this process
    only)."""

    def __enter__(self):
        from repro_torch.kernels import flash_decode, ops
        self.orig = ops.flash_decode
        ops.flash_decode = lambda q, k, v, valid, *, chunk=512, kv_heads=None: \
            flash_decode.flash_decode_plain(q, k, v, valid, chunk=chunk,
                                            kv_heads=kv_heads)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_decode = self.orig


def lm_serve_run(cfg, params, prompts, device, eager=False,
                 serving=contextlib.nullcontext(), keep_logits=False):
    """One ServeEngine run of the prompts: (engine, requests, decode steps,
    wall seconds, the engine's memory after construction). The engine
    captures its decode step at construction; ``eager`` drops the graph
    before serving, so that every step runs ``decode_step`` eagerly (the
    yardstick of the captured steps). ``serving`` is entered around the
    run only, after construction's warm-up and capture. Each decode step
    records whether its logits are finite (and, with ``keep_logits``, a
    copy of them)."""
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
        steps.append({"finite": bool(torch.isfinite(logits).all())}
                     | ({"logits": logits.clone()} if keep_logits else {}))
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
# phase 4b: every other LM family on the card
# --------------------------------------------------------------------------

#: (arch, layers kept (None: the published depth), how it runs, prompt
#: lengths): the captured ServeEngine for the text-only families, the
#: family API (prefill, then greedy decode steps, eager) for vlm and
#: encdec, which the engine does not serve
LM_FAMILY_RUNS = (
    ("olmoe-1b-7b", None, "engine", LM_PROMPTS),
    # a 1,536-token prompt, so that the 1,024-token window masks in the
    # 29 windowed layers
    ("hymba-1.5b", None, "engine", (37, 128, 300, 1536)),
    ("mamba2-130m", None, "engine", LM_PROMPTS),
    # the whole model (316 B parameters) fits no card
    ("grok-1-314b", 2, "engine", LM_PROMPTS),
    # 60 layers (68.8 GB in bf16) would leave no room for a 3,392-token
    # prefill
    ("llava-next-34b", 8, "api", LM_PROMPTS),
    ("whisper-tiny", None, "api", (37,)),
)
#: one SMOKE config per family (and grok's), float32, card against CPU
SMOKE_CARD_ARCHS = ("minitron-4b", "olmoe-1b-7b", "grok-1-314b",
                    "mamba2-130m", "hymba-1.5b", "llava-next-34b",
                    "whisper-tiny")
SMOKE_CARD_TOL = {"rtol": 1e-4, "atol": 1e-4}
ROUTER_MARGIN = 1e-3             # a router pick may flip under this gap


def family_config(arch, depth):
    """The published config, with its depth cut to ``depth`` layers if
    given; and the cut as printed in ``reduced``."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if depth is None:
        return cfg, None
    cut = dataclasses.replace(cfg, n_layers=depth)
    return cut, {"n_layers": [cfg.n_layers, depth],
                 "params": [cfg.param_count(), cut.param_count()]}


class RouterPicks:
    """While active, records each MoE layer call's router probabilities,
    its top-k experts and, per token, the gap between its k-th and
    (k+1)-th probability (``layers.moe_route`` swapped in this process
    only)."""

    def __enter__(self):
        from repro_torch.models import layers
        self.orig, self.picks = layers.moe_route, []

        def route(p, cfg, x):
            probs, top_p, top_e = self.orig(p, cfg, x)
            k = cfg.n_experts_active
            top = probs.topk(k + 1, dim=-1).values
            self.picks.append((probs.clone(), top_e.clone(),
                               top[..., k - 1] - top[..., k]))
            return probs, top_p, top_e
        layers.moe_route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers
        layers.moe_route = self.orig


def routed_limits(got, want, picks_got, picks_want, step):
    """``logit_limits`` of decode step ``step``'s (B, V) logits against
    another run's. A token (batch row) whose set of router picks differs
    between the two runs in some MoE layer is named (step, layer, row, its
    k-th to (k+1)-th probability gap, and the largest change of a router
    probability between the runs) and held to the median only. Its first
    flip must have a gap under ROUTER_MARGIN in one of the runs; later
    layers route a hidden state that the first flip already changed."""
    import torch
    if len(picks_got) != len(picks_want):
        raise AssertionError(f"{len(picks_got)} vs {len(picks_want)} MoE calls")
    flipped = torch.zeros(got.shape[0], dtype=torch.bool, device=got.device)
    flips = []
    for layer, ((pa, ea, ga), (pb, eb, gb)) in enumerate(
            zip(picks_got, picks_want)):
        # a flip changes the set of the k experts; an order change inside
        # it only reorders the token's float32 sum of its k contributions
        diff = (ea.sort(-1).values != eb.sort(-1).values).flatten(1).any(1)
        for row in diff.nonzero().flatten().tolist():
            gap = min(float(ga[row].min()), float(gb[row].min()))
            first = not bool(flipped[row])
            flips.append({"step": step, "layer": layer, "row": row, "gap": gap,
                          "drift": float((pa[row] - pb[row]).abs().max()),
                          "first_in_row": first})
            if first and gap >= ROUTER_MARGIN:
                raise AssertionError(f"router pick flipped at step {step}, "
                                     f"layer {layer}, row {row} with a gap of "
                                     f"{gap}")
        flipped |= diff
    cmp = logit_limits(got, want)
    if flips:
        keep = ~flipped
        unflipped = float((got[keep] - want[keep]).abs().max()) \
            if keep.any() else 0.0
        cmp.update(flips=flips, max_abs_unflipped=unflipped)
        cmp["held"] = bool(torch.isfinite(got).all()) \
            and unflipped <= cmp["tol_max"] \
            and cmp["median_abs"] <= cmp["tol_median"]
    return cmp


def decode_weight_bytes(cfg, params, batch):
    """Weight bytes one decode step reads: every weight of the decoder
    stack (a MoE layer multiplies all its experts), the head and the
    embedding rows of the batch's tokens; for encdec the decoder's only,
    without the cross-attention's K and V projections (the memory's K and
    V are cached)."""
    size = lambda t: t.numel() * t.element_size()
    if cfg.family == "encdec":
        dec = params["dec_layers"]
        total = sum(size(t) for _, t in leaf_paths(dec)) \
            - size(dec["xattn"]["wk"]) - size(dec["xattn"]["wv"]) \
            + size(params["head"]) + size(params["final_norm"])
    else:
        total = sum(size(t) for _, t in leaf_paths(params)) \
            - size(params["embed"])
    return total + batch * cfg.d_model * params["embed"].element_size()


def k5_profiled(fn, n_attn, label, tries=3):
    """One call of ``fn`` under torch.profiler: ``replay_counts`` with
    K5's split and merge kernels, which must each launch ``n_attn`` times.
    The profiler has been seen to drop a kernel's record (PERF.md §7 q3),
    so a short count is profiled again, up to ``tries`` times; a launch
    that is really missing is short every time (and in the wrapper's
    count). Returns the counts and every attempt's kernel counts."""
    attempts = []
    for _ in range(tries):
        counts = replay_counts(fn, K5_KERNELS)
        k = counts["kernels"]
        attempts.append(k)
        if k["flash_decode_mma_kernel"] + k["flash_decode_split_kernel"] \
                == n_attn and k["flash_decode_merge_kernel"] == n_attn:
            return counts, attempts
    raise AssertionError(f"{label}: K5 kernels per call {attempts}; expected "
                         f"{n_attn} split and {n_attn} merge kernels")


def next_step_vs_plain(api, cfg, params, cache, tokens, pos, step):
    """Decode step ``step`` from a state, through K5 and through its plain
    version, each on its own copy of the cache (the SSD states advance in
    place): ``routed_limits``."""
    import torch

    def run(plain):
        copy = {k: v.clone() for k, v in cache.items()}
        with torch.inference_mode(), RouterPicks() as picks, \
                (PlainAttention() if plain else contextlib.nullcontext()):
            logits, _ = api.decode_step(params, cfg, copy, tokens, pos)
        return logits, picks.picks
    got, picks_got = run(False)
    want, picks_want = run(True)
    torch.cuda.synchronize()
    return routed_limits(got, want, picks_got, picks_want, step)


def prefill_ms(api, cfg, params, prompts, device, extras=None):
    """Host ms of one prefill per prompt (B = 1, a fresh cache), after one
    warm-up call of the first; the peak memory statistic restarts here."""
    import torch
    torch.cuda.reset_peak_memory_stats()
    out = []
    for i, prompt in enumerate(prompts):
        batch = {"tokens": torch.as_tensor(prompt, device=device)[None],
                 **(extras or {})}

        def fill():
            with torch.inference_mode():
                api.prefill(params, cfg, api.init_cache(cfg, 1, LM_CACHE_LEN,
                                                        device=device), batch)
        if i == 0:
            fill()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fill()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def family_engine(cfg, params, prompts, device, n_attn, record):
    """One family served by the captured ServeEngine: the run (K5 at the
    warm-up and the capture only), the same run eagerly (every step's
    logits bitwise the replay's, the greedy tokens equal, K5 n_attn times
    a step), the next step through K5 against the plain attention, one
    replay under the profiler, step timing and prefill times."""
    import torch
    from repro_torch.kernels import flash_decode
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    flash_decode.LAUNCHES = 0
    engine, reqs, steps, wall, memory = lm_serve_run(
        cfg, params, prompts, device, keep_logits=True)
    launches = flash_decode.LAUNCHES
    serve_peak = torch.cuda.max_memory_allocated()   # construction + serving
    n_steps = len(steps)
    if n_steps != LM_NEW_TOKENS - 1 or engine.compile_count != 1 \
            or launches != 2 * n_attn:
        raise AssertionError(f"{cfg.name}: {launches} K5 launches over "
                             f"{n_steps} steps, compile_count "
                             f"{engine.compile_count}; expected {2 * n_attn}")
    for r in reqs:
        if not (r.done and len(r.output) == LM_NEW_TOKENS
                and all(0 <= t < cfg.vocab_size for t in r.output)):
            raise AssertionError(f"{cfg.name} request {r.rid}: {r.output}")
    if not all(s["finite"] for s in steps):
        raise AssertionError(f"{cfg.name}: non-finite decode logits")

    rec = Recorder(flash_decode, "flash_decode", 1) if record \
        else contextlib.nullcontext()
    flash_decode.LAUNCHES = 0
    eager_engine, eager_reqs, eager_steps, eager_wall, _ = lm_serve_run(
        cfg, params, prompts, device, eager=True, serving=rec, keep_logits=True)
    eager_launches = flash_decode.LAUNCHES - 2 * n_attn    # minus construction
    del eager_engine
    bitwise = [bool(torch.equal(a["logits"], b["logits"]))
               for a, b in zip(steps, eager_steps)]
    same_tokens = [r.output for r in reqs] == [r.output for r in eager_reqs]
    if len(eager_steps) != n_steps or not all(bitwise) or not same_tokens \
            or eager_launches != n_attn * n_steps:
        raise AssertionError(f"{cfg.name}: replay vs eager bitwise {bitwise}, "
                             f"tokens equal {same_tokens}, eager K5 launches "
                             f"{eager_launches} (expected {n_attn * n_steps})")
    for s in steps + eager_steps:
        s.pop("logits")

    tokens, pos = engine.last_tok.clone(), engine.pos.clone()
    vs_plain = next_step_vs_plain(api, cfg, engine.params, engine.cache,
                                  tokens, pos, n_steps)
    if not vs_plain["held"]:
        raise AssertionError(f"{cfg.name}: K5 vs plain attention {vs_plain}")
    replay, attempts = k5_profiled(engine.decode_logits, n_attn,
                                   f"{cfg.name} replay")
    check_replay(f"{cfg.name} decode step", replay, {}, want_pinned=0)

    def eager_step():
        with torch.inference_mode():
            api.decode_step(engine.params, cfg, engine.cache, tokens, pos)
    timing = step_timing({"eager": eager_step, "captured": engine.decode_logits})
    del engine
    memory_mark()
    pre_ms = prefill_ms(api, cfg, params, prompts, device)
    return {"route": "ServeEngine, captured", "launches": launches,
            "finite_logits": all(s["finite"] for s in steps + eager_steps),
            "peaks": [serve_peak, torch.cuda.max_memory_allocated()]
            + [t["peak_allocated_bytes"] for t in timing.values()],
            "decode_steps": n_steps, "wall_s": wall, "eager_wall_s": eager_wall,
            "outputs": [r.output for r in reqs], "memory": memory,
            "replay_vs_eager_bitwise": all(bitwise),
            "eager_k5_launches_per_step": eager_launches / n_steps,
            "replay": replay, "profiled_k5_attempts": attempts,
            "decode_vs_plain": vs_plain, "steps": timing,
            "prefill_ms": pre_ms,
            "k5_call": None if not record else
            ([t.clone() for t in rec.calls[0][0]], rec.calls[0][1])}


def family_api(cfg, params, prompts, device, n_attn):
    """A family the engine does not serve, through its API: per prompt a
    prefill of the stub frontend's embeddings plus the text (vlm: B = 1
    over 2,880 image embeddings; encdec: B = LM_MAX_BATCH over 1,500
    frames), then LM_NEW_TOKENS - 1 greedy decode steps, eager, K5
    n_attn times a step; on the last prompt's state the next step through
    K5 against the plain attention, one step under the profiler, and step
    timing."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_decode
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    if cfg.family == "vlm":
        b, n_ctx = 1, cfg.n_img_tokens
        extras = {"img_embeds": torch.randn((b, n_ctx, cfg.d_model), generator=gen,
                                            device=device).to(cfg.dtype)}
    else:
        b, n_ctx = LM_MAX_BATCH, 0
        extras = {"frames": torch.randn((b, cfg.enc_seq_len, cfg.d_model),
                                        generator=gen, device=device).to(cfg.dtype)}
    launches, outputs, pre_ms, finite = 0, [], [], True
    for prompt in prompts:
        toks = torch.as_tensor(np.stack([prompt] * b), device=device)
        cache = api.init_cache(cfg, b, LM_CACHE_LEN, device=device)
        flash_decode.LAUNCHES = 0
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = api.prefill(params, cfg, cache,
                                        {"tokens": toks, **extras})
            torch.cuda.synchronize()
            pre_ms.append((time.perf_counter() - t0) * 1e3)
            out = [logits.argmax(-1).to(torch.int32)]
            for i in range(LM_NEW_TOKENS - 1):
                pos = torch.full((b,), n_ctx + len(prompt) + i, dtype=torch.int32,
                                 device=device)
                logits, cache = api.decode_step(params, cfg, cache, out[-1], pos)
                finite &= bool(torch.isfinite(logits).all())
                if not finite:
                    raise AssertionError(f"{cfg.name}: non-finite logits")
                out.append(logits.argmax(-1).to(torch.int32))
        if flash_decode.LAUNCHES != n_attn * (LM_NEW_TOKENS - 1):
            raise AssertionError(f"{cfg.name}: {flash_decode.LAUNCHES} K5 "
                                 f"launches over {LM_NEW_TOKENS - 1} steps")
        launches += flash_decode.LAUNCHES
        outputs.append(torch.stack(out, 1).tolist())
    serve_peak = torch.cuda.max_memory_allocated()   # prefills and decodes
    tokens = out[-1]
    pos = torch.full((b,), n_ctx + len(prompts[-1]) + LM_NEW_TOKENS - 1,
                     dtype=torch.int32, device=device)
    vs_plain = next_step_vs_plain(api, cfg, params, cache, tokens, pos,
                                  LM_NEW_TOKENS - 1)
    if not vs_plain["held"]:
        raise AssertionError(f"{cfg.name}: K5 vs plain attention {vs_plain}")

    def eager_step():
        with torch.inference_mode():
            api.decode_step(params, cfg, cache, tokens, pos)
    _, attempts = k5_profiled(eager_step, n_attn, f"{cfg.name} eager step")
    timing = step_timing({"eager": eager_step})
    del cache
    memory_mark()
    return {"route": "api.prefill + api.decode_step, eager", "batch": b,
            "finite_logits": finite,
            "peaks": [serve_peak] + [t["peak_allocated_bytes"]
                                     for t in timing.values()],
            "context_embeddings": n_ctx or cfg.enc_seq_len,
            "launches": launches, "decode_steps": len(prompts) * (LM_NEW_TOKENS - 1),
            "eager_k5_launches_per_step": n_attn,
            "profiled_k5_attempts": attempts,
            "outputs": outputs, "decode_vs_plain": vs_plain, "steps": timing,
            "prefill_ms": pre_ms}


def smoke_card_vs_cpu(device):
    """Each family's SMOKE config in float32, the same weights on the card
    and on the CPU: prefill and three decode steps, logits and every
    cache leaf within SMOKE_CARD_TOL."""
    import numpy as np
    import torch
    from repro_torch.bridge import tree_to
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import get_api
    out = {}
    for arch in SMOKE_CARD_ARCHS:
        cfg = get_smoke_config(arch)
        api = get_api(cfg)
        cpu_params = api.init(cfg, torch.Generator().manual_seed(SEED),
                              device="cpu")
        rng = np.random.default_rng(SEED)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)
                                             ).astype(np.int32))
        nxt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (3, 2)
                                            ).astype(np.int32))
        extras = {}
        if cfg.family == "vlm":
            extras["img_embeds"] = torch.from_numpy(rng.normal(
                size=(2, cfg.n_img_tokens, cfg.d_model)).astype(np.float32))
        if cfg.family == "encdec":
            extras["frames"] = torch.from_numpy(rng.normal(
                size=(2, cfg.enc_seq_len, cfg.d_model)).astype(np.float32))

        def run(params, dev):
            cache = api.init_cache(cfg, 2, 32, device=dev)
            batch = {k: v.to(dev) for k, v in {"tokens": toks, **extras}.items()}
            with torch.inference_mode():
                logits, cache = api.prefill(params, cfg, cache, batch)
                outs = [logits]
                for i in range(3):
                    pos = torch.full((2,), 9 + cfg.n_img_tokens + i,
                                     dtype=torch.int32, device=dev)
                    logits, cache = api.decode_step(params, cfg, cache,
                                                    nxt[i].to(dev), pos)
                    outs.append(logits)
            return outs, cache
        want, want_cache = run(cpu_params, "cpu")
        got, got_cache = run(tree_to(cpu_params, device), device)
        err = max(check_close(f"{arch} SMOKE card vs CPU step {i}", g.cpu(), w,
                              SMOKE_CARD_TOL)
                  for i, (g, w) in enumerate(zip(got, want)))
        for name, w in want_cache.items():
            g = got_cache[name].cpu()
            if name == "kpos":
                if not torch.equal(g, w):
                    raise AssertionError(f"{arch} SMOKE kpos card vs CPU")
            else:
                err = max(err, check_close(f"{arch} SMOKE cache {name}", g, w,
                                           SMOKE_CARD_TOL))
        out[arch] = {"family": cfg.family, "max_abs_err": err,
                     "cache_leaves": sorted(want_cache)}
    return out


def phase_lm_families(device):
    """Every LM family besides dense on the card (LM_FAMILY_RUNS; bf16,
    random weights drawn on the card from the seed, each model freed
    before the next is drawn), then each family's SMOKE config on the
    card against the CPU. Returns the K5 launches of the families' main
    path and hymba's first served K5 call (the timing phase's operands)."""
    import torch
    from repro_torch.models.registry import get_api
    t0 = time.perf_counter()
    rows, launches, hymba_call = [], 0, None
    for arch, depth, route, prompt_lens in LM_FAMILY_RUNS:
        cfg, reduced = family_config(arch, depth)
        n_attn = 0 if cfg.family == "ssm" else cfg.n_layers
        memory_mark()
        # live before the model: what earlier phases still hold
        before = torch.cuda.memory_allocated()
        t_model = time.perf_counter()
        params = get_api(cfg).init(
            cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
        param_bytes = sum(t.numel() * t.element_size()
                          for _, t in leaf_paths(params))
        init_peak = torch.cuda.max_memory_allocated()    # the draw's float32
        torch.cuda.reset_peak_memory_stats()
        prompts = seeded_prompts(cfg.vocab_size, prompt_lens)
        batch = LM_MAX_BATCH if route == "engine" or cfg.family == "encdec" else 1
        if route == "engine":
            res = family_engine(cfg, params, prompts, device, n_attn,
                                record=arch == "hymba-1.5b")
            if arch == "hymba-1.5b":
                hymba_call = res["k5_call"]
            res.pop("k5_call")
        else:
            res = family_api(cfg, params, prompts, device, n_attn)
        weights = decode_weight_bytes(cfg, params, batch)
        launches += res["launches"]
        rows.append({"model": cfg.name, "family": cfg.family,
                     "dtype": str(cfg.dtype), "layers": cfg.n_layers,
                     "attention_layers": n_attn, "reduced": reduced,
                     "params": cfg.param_count(), "param_bytes": param_bytes,
                     "prompts": list(prompt_lens),
                     "allocated_before_bytes": before,
                     "init_peak_allocated_bytes": init_peak,
                     "peak_allocated_bytes": max(res.pop("peaks")),
                     "decode_weight_bytes": weights,
                     "decode_weight_bound_ms": weights / HBM_BYTES_PER_S * 1e3,
                     "seconds": time.perf_counter() - t_model, **res})
        del params
    memory_mark()
    smoke = smoke_card_vs_cpu(device)
    emit("lm_families", configs=rows, smoke_card_vs_cpu=smoke,
         tolerance={"decode_vs_plain": "logit_limits (max 2^-4, median 2^-8 "
                                       "of the largest |logit|); a row whose "
                                       "router set flipped (first flip's gap "
                                       "< 1e-3): median only",
                    "replay_vs_eager": "bitwise",
                    "smoke_card_vs_cpu": SMOKE_CARD_TOL},
         k5_launches=launches, seconds=time.perf_counter() - t0)
    return {"launches": launches, "k5_call": hymba_call}


# --------------------------------------------------------------------------
# phase 4b: streaming video through persistent value caches
# --------------------------------------------------------------------------

def stream_setup(device):
    """The streamed detector's decoder and heads at full width (random
    weights from the seed), its 512 px level shapes, and one drifting
    scene of STREAM_FRAMES encoder memories per session, plus one for the
    session admitted mid-stream."""
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
              for i in range(STREAM_SESSIONS + 1)]
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
    idle share, K2 launches, device kernels, graph launches, host-to-device
    copies from pageable and from pinned memory, and the device ms of
    all host-to-device copies."""
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
    events = [e for e in prof.key_averages()
              if not e.key.startswith("ProfilerStep")]
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(_device_us(e) for e in dev) / 1e3
    count = lambda evts, frag: sum(e.count for e in evts if frag in e.key)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": max(0.0, 1 - busy / wall),
            "k2_launches": count(dev, "msgs_decode_kernel"),
            "device_kernels": sum(e.count for e in dev),
            "graph_launches": count([e for e in events
                                     if e.device_type == DeviceType.CPU],
                                    "cudaGraphLaunch"),
            "htod_pageable": count(dev, "Memcpy HtoD (Pageable"),
            "htod_pinned": count(dev, "Memcpy HtoD (Pinned"),
            "htod_ms": sum(_device_us(e) for e in dev
                           if "Memcpy HtoD" in e.key) / 1e3}


STREAM_PATHS = ("build", "frame", "restage", "hysteresis", "decode")


def stream_record(engine, keep_tables, keep_state):
    """What one step left, read from the engine's outputs and the
    manager's standing tensors (a replay runs no Python of its paths):
    the frame's memory, the keep state the frame's cache was built under,
    the activation scale, the frame stats, copies of the outputs and,
    as asked, of the tables and of the rest of the stream state; the
    first-call counts of every path."""
    mgr = engine.mgr
    clone = lambda t: None if t is None else t.clone()
    state = lambda st: None if st is None else type(st)(*map(clone, st))
    rec = {"memory": engine._memory.clone(), "fwp": state(mgr._cache_fwp),
           "act_scale": clone(mgr.act_scale),
           "stats": dict(mgr.last_stats),
           "outputs": tuple(t.clone() for t in engine.last_outputs),
           "traces": {fn: mgr._m_traces.value(fn=fn) for fn in STREAM_PATHS}}
    c = mgr.cache
    if keep_tables or keep_state:
        rec["tables"] = (clone(c.v), clone(c.staged.v), clone(c.scale))
    if keep_state:
        rec["state"] = {"x_ref": clone(mgr.x_ref), "ema": clone(mgr.ema),
                        "fwp": state(mgr.fwp), "pix2slot": clone(c.pix2slot),
                        "keep_idx": clone(c.keep_idx),
                        "staged_scale": clone(c.staged.scale)}
    return rec


def stream_pass(setup, device, attn, order, *, scfg=None, profiled=(),
                reorder_before=None, keep_tables=False, keep_state=False,
                obs=None, capture=True, churn_at=(), update_fwp=True):
    """One StreamingDetrEngine over the scenes, its paths CUDA graphs
    unless ``capture`` is False: the session opened k-th (slot k) streams
    scene ``order[k]``; one engine step per frame. Per frame the
    ``stream_record`` of the step, the graphs it captured, the host ms
    of staging its frames, and the host wall clock of the step (or, for
    the frames in ``profiled``, one profiler step). Before each frame of ``churn_at`` the last session
    opened is closed and a new one, streaming the extra scene from that
    frame on, takes its slot; before ``reorder_before`` the engine
    reorders its sessions. ``results`` holds the live sessions' by
    scene."""
    import torch
    from repro_torch.obs import Observability
    from repro_torch.serve import StreamingDetrEngine
    engine = StreamingDetrEngine(
        attn, setup["dec_cfg"], setup["params"], setup["levels"],
        max_sessions=STREAM_SESSIONS, backend="cuda_decode",
        stream_cfg=scfg, update_fwp=update_fwp,
        obs=obs or Observability.disabled(), device=device, capture=capture)
    live = {engine.open_session(): scene for scene in order}
    records, steps, mapping = [], [], None
    frame_in = engine._frame_memory
    frame_in_ms = []

    def timed_frame_in(pending):       # the host's share: staging the
        t0 = time.perf_counter()       # frames into the pinned buffers
        frame_in(pending)
        frame_in_ms.append((time.perf_counter() - t0) * 1e3)
    engine._frame_memory = timed_frame_in
    for t in range(STREAM_FRAMES):
        if t in churn_at:
            last = max(live)
            engine.close_session(last)
            del live[last]
            live[engine.open_session()] = STREAM_SESSIONS
        if t == reorder_before:
            before = {sid: s.slot for sid, s in engine.sessions.items()}
            mapping = {"before": before,
                       "after": engine.reorder_sessions()}
        for sid, scene in live.items():
            engine.submit_frame(sid, setup["scenes"][scene][t])
        captures = engine.mgr.graphs.captures
        if t in profiled:
            steps.append(profile_step(engine.step))
        else:
            t0 = time.perf_counter()
            engine.step()
            torch.cuda.synchronize()
            steps.append({"wall_ms": (time.perf_counter() - t0) * 1e3})
        steps[-1]["graphs_captured"] = engine.mgr.graphs.captures - captures
        steps[-1]["frame_in_ms"] = frame_in_ms[-1]
        records.append(stream_record(engine, keep_tables, keep_state))
    results = {scene: [(r["cls_probs"], r["boxes"])
                       for r in engine.sessions[sid].results]
               for sid, scene in live.items()}
    return {"engine": engine, "records": records, "steps": steps,
            "results": results, "mapping": mapping}


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
    """Median, p10 and p90 of the step wall clock per frame mode, over the
    frames that captured no graph (a capture's frame is reported by
    ``capture_frames``), and the median host ms of staging the frames
    (``frame_in_ms``)."""
    out = {}
    for mode in ("rebuild", "partial", "incremental"):
        rows = [s for s, r in zip(steps, records)
                if r["stats"]["mode"] == mode and not s["graphs_captured"]]
        if not rows:
            continue
        ts = [s["wall_ms"] for s in rows]
        dec = statistics.quantiles(ts, n=10) if len(ts) > 1 else [ts[0]] * 9
        out[mode] = {"n": len(ts), "median_ms": statistics.median(ts),
                     "p10_ms": dec[0], "p90_ms": dec[-1],
                     "frame_in_ms": statistics.median(s["frame_in_ms"]
                                                      for s in rows)}
    return out


def capture_frames(run):
    """The frames whose step captured graphs: mode, graphs, wall ms."""
    return [{"frame": t, "mode": r["stats"]["mode"],
             "graphs": s["graphs_captured"], "wall_ms": s["wall_ms"]}
            for t, (s, r) in enumerate(zip(run["steps"], run["records"]))
            if s["graphs_captured"]]


def stream_frames(run):
    return [{k: r["stats"][k] for k in ("mode", "reason", "n_dirty",
                                         "tiles_changed", "staged_bytes",
                                         "rebuild_bytes", "restaged_levels",
                                         "admitted_slots")}
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
    """After the last frame: a fresh staging of the updated table equals
    the staged table bitwise; K2 on the staged table, as an eager decoder
    call on the final cache hands it (each layer's call), equals K2 on
    the fresh staging bitwise and its plain version within the kernel
    tolerance. Returns the checks and those calls."""
    import torch
    from repro_torch.kernels import msgs_decode
    engine = run["engine"]
    cache = engine.mgr.cache
    fresh = msgs_decode.stage_decode_table(
        cache.v, cache.pix2slot, head_pack=cache.staged.head_pack,
        scale=cache.scale)
    if not torch.equal(fresh.v, cache.staged.v):
        raise AssertionError("stream: the updated staged table differs from "
                             "a fresh staging of the updated table")
    n_layers = engine.dec_cfg.n_layers
    with Recorder(msgs_decode, "msgs_decode", n_layers) as rec_d:
        engine.forward(engine._memory, cache)
    errs = []
    for args, _ in rec_d.calls:
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
            "last_frame_mode": run["records"][-1]["stats"]["mode"]}, \
        rec_d.calls


def stream_flat(rec):
    """The tensors of a ``stream_record``, by name."""
    out = {"logits": rec["outputs"][0], "boxes": rec["outputs"][1],
           "memory": rec["memory"], "act_scale": rec["act_scale"]}
    for name, st in (("cache_fwp", rec["fwp"]),
                     ("fwp", rec.get("state", {}).get("fwp"))):
        if st is not None:
            out.update({f"{name}.{f}": t for f, t in zip(st._fields, st)})
    out.update(zip(("v", "staged", "scale"), rec.get("tables", ())))
    out.update({k: t for k, t in rec.get("state", {}).items() if k != "fwp"})
    return out


def stream_bitwise(label, captured, eager):
    """Frame by frame, a captured pass against the eager pass on the same
    scenes: the same modes, and every recorded tensor (outputs, value and
    staged tables, scales, diff reference, EMA, both keep states) bitwise
    equal. Returns the frames' modes."""
    import torch
    frames = []
    for t, (a, b) in enumerate(zip(captured["records"], eager["records"])):
        sa, sb = a["stats"], b["stats"]
        keys = ("mode", "reason", "n_dirty", "admitted_slots",
                "restaged_levels")
        if any(sa[k] != sb[k] for k in keys):
            raise AssertionError(f"{label} frame {t}: captured {sa} vs eager "
                                 f"{sb}")
        fa, fb = stream_flat(a), stream_flat(b)
        bad = [k for k in fa if (fa[k] is None) != (fb[k] is None)
               or fa[k] is not None and not torch.equal(fa[k], fb[k])]
        if bad or set(fa) != set(fb):
            raise AssertionError(f"{label} frame {t} ({sa['mode']}): "
                                 f"captured vs eager not bitwise in {bad}")
        frames.append({"mode": sa["mode"], "reason": sa["reason"],
                       "admitted_slots": list(sa["admitted_slots"]),
                       "restaged_levels": list(sa["restaged_levels"]),
                       "compared": len(fa)})
    return {"bitwise": True, "frames": frames,
            "modes": sorted({f["mode"] for f in frames})}


def stream_profiled(run, n_layers, captured):
    """The profiled frames of a pass by mode: wall ms, device busy ms,
    idle share, device kernels, graph launches, K2 launches; each frame
    must launch K2 once per layer and copy nothing pageable to the card,
    and a captured frame must launch graphs where an eager one launches
    none."""
    by_mode = {}
    for t, (s, r) in enumerate(zip(run["steps"], run["records"])):
        if "device_busy_ms" not in s:
            continue
        if s["k2_launches"] != n_layers or s["htod_pageable"] \
                or (s["graph_launches"] > 0) != captured:
            raise AssertionError(f"stream frame {t} "
                                 f"({r['stats']['mode']}, captured "
                                 f"{captured}): {s}")
        m = by_mode.setdefault(r["stats"]["mode"], {
            k: [] for k in ("wall_ms", "device_busy_ms", "idle_share",
                            "device_kernels", "graph_launches",
                            "k2_launches", "htod_pageable", "htod_pinned",
                            "htod_ms")})
        for k in m:
            m[k].append(s[k])
    return by_mode


def idle_at_median(profiled, walls):
    """1 - (median device busy ms of a mode's profiled frames) / (median
    wall ms of that mode's timed frames): the profiler slows the host,
    so its own idle share is an upper bound."""
    return {mode: max(0.0, 1 - statistics.median(p["device_busy_ms"])
                      / walls[mode]["median_ms"])
            for mode, p in profiled.items() if mode in walls}


def graph_pool_bytes(graphs):
    """Bytes of the device segments in a graph set's pool
    (``utils.graphs.CapturedGraphs``)."""
    import torch
    pool = graphs._pool
    if pool is None:
        return 0
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) == tuple(pool))


STREAM_CHURN_AT = (3, 5)          # frames before which a session leaves
#   and a new one is admitted into its slot


def stream_churn(setup, device, table):
    """Captured against eager under session churn: a session closed and a
    new one admitted before each frame of STREAM_CHURN_AT, a reorder
    before the last frame; bitwise per frame, each churn an admission
    frame, and from the first admission on no path called for the first
    time. The keep state stays the warm one here (no frequency feedback,
    act_bits None): a joining session is then admitted into its slot,
    where a pending keep transition or a frozen act grid would rebuild
    the batch instead."""
    from repro_torch.obs import Observability
    attn = stream_attn(setup, table_dtype=table, act_bits=None)
    runs = {}
    for capture in (True, False):
        runs[capture] = stream_pass(
            setup, device, attn, list(range(STREAM_SESSIONS)),
            keep_state=True, obs=Observability.create(), capture=capture,
            churn_at=STREAM_CHURN_AT, reorder_before=STREAM_FRAMES - 1,
            update_fwp=False)
    got, want = runs[True], runs[False]
    t0 = STREAM_CHURN_AT[0]
    if not all(got["records"][t]["stats"]["admitted_slots"]
               for t in STREAM_CHURN_AT):
        raise AssertionError(f"stream churn {table}: no admission frame "
                             f"({stream_frames(got)})")
    traces = [r["traces"] for r in got["records"]]
    if any(tr != traces[t0] for tr in traces[t0:]):
        raise AssertionError(f"stream churn {table}: a path was called for "
                             f"the first time after the admission: {traces}")
    return {"churn_at": list(STREAM_CHURN_AT),
            "captured_vs_eager": stream_bitwise(f"stream churn {table}",
                                                got, want),
            "traces_by_frame": traces,
            "reorder": {k: {str(s): v for s, v in m.items()}
                        for k, m in got["mapping"].items()},
            "wall_ms_by_mode": {
                "captured": wall_split(got["steps"], got["records"]),
                "eager": wall_split(want["steps"], want["records"])},
            "capture_frames": capture_frames(got)}


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
    """One table dtype at the config's INT12: a timed captured pass and an
    eager pass (``capture=False``) on the same scenes, bitwise equal frame
    by frame; the captured and the eager pass profiled; outputs against
    scratch builds (DEFA's limits); launches, wall clock by mode, busy
    and idle share, graph pool bytes, peak memory; the churn passes."""
    import torch
    from repro_torch.kernels import (flash_decode, matmul, msgs_decode,
                                     msgs_fused, msgs_windowed)
    from repro_torch.obs import Observability
    attn = stream_attn(setup, table_dtype=table)
    n_layers = setup["dec_cfg"].n_layers
    order = list(range(STREAM_SESSIONS))
    mods = {"msgs_decode": msgs_decode, "msgs_fused": msgs_fused,
            "msgs_windowed": msgs_windowed, "flash_decode": flash_decode,
            "matmul": matmul}

    def launches(run, **kw):
        for m in mods.values():
            m.LAUNCHES = 0
        out = run(**kw)
        got = {n: m.LAUNCHES for n, m in mods.items()}
        return out, got
    obs = Observability.default() if obs_log else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    timed, captured_launches = launches(
        stream_pass, setup=setup, device=device, attn=attn, order=order,
        keep_state=True, obs=obs)
    memory = {"peak_allocated_bytes": torch.cuda.max_memory_allocated() - base,
              "graph_pool_bytes": graph_pool_bytes(timed["engine"].mgr.graphs),
              "graphs": len(timed["engine"].mgr.graphs)}
    frames = len(timed["records"])
    # on the card K2's wrapper runs only in the decode graph's warm-up and
    # capture; the eager pass calls it on every frame
    if captured_launches != {"msgs_decode": 2 * n_layers, "msgs_fused": 0,
                             "msgs_windowed": 0, "flash_decode": 0,
                             "matmul": 0}:
        raise AssertionError(f"stream {table}: wrapper launches "
                             f"{captured_launches} over {frames} captured "
                             f"frames; expected 2 x 6 K2 (warm-up, capture)")
    log = None
    if obs_log:
        timed["engine"].obs.flush_metrics()
        timed["engine"].obs.close()
        log = validate_log(obs_log, STREAM_METRICS)
    eager, eager_launches = launches(
        stream_pass, setup=setup, device=device, attn=attn, order=order,
        keep_state=True, capture=False)
    if eager_launches["msgs_decode"] != n_layers * frames:
        raise AssertionError(f"stream {table}: eager launches "
                             f"{eager_launches} over {frames} frames")
    bitwise = stream_bitwise(f"stream {table}", timed, eager)
    # the profiled captured pass profiles the frames that capture nothing
    # (the timed pass on the same scenes shows which)
    warm = [t for t, s in enumerate(timed["steps"])
            if not s["graphs_captured"]]
    profiled = stream_pass(setup, device, attn, order, profiled=warm)
    profiled_eager = stream_pass(setup, device, attn, order,
                                 profiled=range(frames), capture=False)
    modes = [r["stats"]["mode"] for r in timed["records"]]
    for run in (profiled, profiled_eager):
        if modes != [r["stats"]["mode"] for r in run["records"]]:
            raise AssertionError(f"stream {table}: a profiled pass took "
                                 f"other modes than the timed one: {modes}")
    compare = {}
    # an int8 scratch build quantizes against a FRESH per-channel scale,
    # which a keep transition can move far from the frozen one: its
    # distance is reported; the same-grid table is what the stream must hold
    scratch = stream_against_scratch(f"stream_{table}", timed, compare,
                                     fresh_limits=table != "int8")
    staged, k2_calls = stream_staged_checks(timed)
    # the profiler has recorded no host-to-device copy of these frames,
    # pinned or pageable: that the staging buffers are pinned is checked
    staging_pinned = all(b.is_pinned() for b in timed["engine"]._pinned)
    if not staging_pinned:
        raise AssertionError(f"stream {table}: staging buffers not pinned")
    report = timed["engine"].report()
    walls = {"captured": wall_split(timed["steps"], timed["records"]),
             "eager": wall_split(eager["steps"], eager["records"])}
    prof = {"captured": stream_profiled(profiled, n_layers, True),
            "eager": stream_profiled(profiled_eager, n_layers, False)}
    rec = {"table_dtype": table, "frames": stream_frames(timed),
           "report": report,
           "launches": {"captured_wrapper": captured_launches,
                        "eager_wrapper": eager_launches},
           "captured_vs_eager": bitwise,
           "wall_ms_by_mode": walls,
           "capture_frames": capture_frames(timed),
           "profiled": prof,
           "idle_share_at_median": {
               k: idle_at_median(prof[k], walls[k]) for k in prof},
           "memory": memory, "staging_pinned": staging_pinned,
           "against_scratch": scratch,
           "defa_limits": compare, "staged": staged, "obs_log": log,
           "churn": stream_churn(setup, device, table),
           "capacity": timed["engine"].capacity_estimate(),
           "plan": timed["engine"].describe()}
    timed["k2_calls"] = k2_calls
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
    config's INT12), each frame replayed from CUDA graphs and held bitwise
    to the eager engine (``capture=False``), with and without session
    churn; the same with act_bits None (outputs within 1e-5 of scratch
    builds); delta_threshold 0 (f32: bitwise a rebuild; int8: what holds
    is reported); reorder_sessions; query ordering on the 512 px bucket;
    the stream log through the validator."""
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
    # K2 per frame of the main path: one per layer, from the decode
    # graph's replay (the profiler's count, checked per frame) or, on the
    # frame that captures it, its warm-up
    return {"int8_k2_calls": int8_run["k2_calls"],
            "int8_launches": setup["dec_cfg"].n_layers * STREAM_FRAMES,
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
    wrapper call launches, once each), keyed by that name; profiler,
    CUPTI. Each kernel's time is the mean over the launches the profiler
    recorded: it may drop records (it kept 1 of 20 once), so dividing
    its total by ``calls`` would undercount. A session that records no
    device event is taken again with 4x the calls, up to PROFILE_TRIES
    sessions (``PROFILER_MISSES`` lists them): a 20-call session of K2 (a
    few microseconds a launch) recorded none three times running, an
    80-call one did. Returns (split, the calls of the session read); the
    split is empty when the profiler records no device time on this
    machine."""
    names = (kernel_names,) if isinstance(kernel_names, str) else kernel_names
    for attempt in range(PROFILE_TRIES):
        dev, _, _ = profile(fn, calls)
        if dev:
            break
        # in the whole script the first profiler session of a timed kernel
        # has been seen to record no device activity at all (every kernel
        # of the times phase); a longer second session did
        PROFILER_MISSES.append({"kernels": list(names), "attempt": attempt,
                                "calls": calls})
        calls *= 4
    # pooled over every profiler entry a name matches (total device time
    # over total launches): a kernel recorded under two entries is not
    # counted twice
    pooled = {}
    for e in dev:
        for n in names:
            if n in e.key and _device_us(e) > 0:
                us, count, entries = pooled.get(n, (0.0, 0, 0))
                pooled[n] = (us + _device_us(e), count + e.count, entries + 1)
    PROFILER_ENTRIES.update({n: entries for n, (_, _, entries)
                             in pooled.items() if entries > 1})
    split = {n: us / count / 1e3 for n, (us, count, _) in pooled.items()}
    return split, calls


#: profiles of kernel_device_split that missed a kernel (times reports them)
PROFILER_MISSES = []
#: kernels recorded under more than one profiler entry, and how many
PROFILER_ENTRIES = {}
PROFILE_TRIES = 3


def kernel_device_ms(fn, kernel_names, calls=20):
    """The sum of ``kernel_device_split``; None without device time."""
    split, _ = kernel_device_split(fn, kernel_names, calls)
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
    split, calls = kernel_device_split(call, kernel_names)
    return {"ms": sum(split.values()) if split else call_ms,
            "ms_source": "profiler" if split else "cuda_events",
            "by_kernel": split, "profile_calls": calls if split else None,
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
    """Median host time of one B = 2 train step, captured and eager
    (``capture=False``, steps built anew from the train phase's initial
    state), each ending in a synchronize, after one warm-up step; and the
    captured step as a function for the profile."""
    import torch
    from repro_torch.train.step import build_train_step
    box = [train["state"]]

    def stepper(capture):
        step = build_train_step(train["cfg"], train["opt_cfg"], train["api"],
                                capture=capture)

        def run():
            box[0], _ = step(box[0], train["batch"])
            torch.cuda.synchronize()
        return run
    out = {}
    for label in ("captured", "eager"):
        run = stepper(label == "captured")
        run()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            ts.append((time.perf_counter() - t0) * 1e3)
        out[label] = statistics.median(ts)
        if label == "captured":
            captured = run
    return out, captured


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


def k5_pass(q, *kv):
    """The split pass K5 runs on these operands (``kv``: K and V)."""
    from repro_torch.kernels import flash_decode
    return flash_decode.split_pass(q.dtype, q.shape[2],
                                   all(t.data_ptr() % 16 == 0 for t in kv))


def flash_decode_bound(q, k, v, valid, out, kv_heads=None):
    """Least time for K5's function on these inputs: q, the mask and the
    output once (the partial mode's ``out``: its float32 output and lse),
    and the K and V rows of the valid slots of the KV heads the query
    heads read (``kv_heads``: of the heads the cache stores; a row with no
    valid slot needs all its V rows and no K, in the partial mode
    nothing); 4 operations per channel, query head and needed slot (the
    score's multiply-add and P.V's)."""
    from repro_torch.kernels import flash_decode
    b, hq, dh = q.shape
    _, w, hkv, _ = k.shape
    n_valid = valid.sum(1)
    empty = (n_valid == 0) & (not isinstance(out, tuple))
    k_rows = int(n_valid.sum())
    v_rows = k_rows + int(empty.sum()) * w
    read = len(set(flash_decode.default_kv_heads(hq, hkv) if kv_heads is None
                   else kv_heads))
    row = read * dh * k.element_size()
    outs = out if isinstance(out, tuple) else (out,)   # partial: (out, lse)
    kv_bytes = (k_rows + v_rows) * row
    nbytes = nbytes_of(q, valid, *outs) + kv_bytes
    ops = 4 * dh * hq * (k_rows + int(empty.sum()) * w)
    return dict(roofline(nbytes, ops, q.dtype), valid_slots=k_rows,
                slots=b * w, kv_bytes=kv_bytes)


def matmul_bound(x, w, scale, out):
    """Least time for K4: x, w (and the scale) read once, the output
    written once, 2 M N K operations at x's rate."""
    m, k = x.shape
    return roofline(nbytes_of(x, w, scale, out), 2 * m * k * w.shape[1],
                    x.dtype)


def sdpa_call(q, k, v, valid, kv_heads=None):
    """The library's one call for K5's function (GQA and a boolean mask);
    used only as a yardstick. With a head map, on a view of the block of
    KV heads it reads where the map is the GQA grouping of that block
    (None where no one call computes the map)."""
    import torch.nn.functional as F
    if kv_heads is not None:
        lo, n = min(kv_heads), max(kv_heads) - min(kv_heads) + 1
        if len(kv_heads) % n or list(kv_heads) != [
                lo + h // (len(kv_heads) // n) for h in range(len(kv_heads))]:
            return None
        k, v = k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    return lambda: F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)


K5_KERNELS = ("flash_decode_split_kernel", "flash_decode_mma_kernel",
              "flash_decode_merge_kernel")
#: the kernels one K4 call launches, by route
K4_KERNELS = {"wgmma": ("matmul_wgmma_kernel", "matmul_splitk_reduce_kernel"),
              "simt": ("matmul_kernel",)}


def k5_entry(args, kw, launches):
    """K5 on a call's operands (``kw`` as the call had them): the kernel
    against its plain version, times, bound and the library call. With
    ``partial`` (a rank's call of the split-cache decode) the row is
    ``flash_decode_partial``: its float32 output and lse held to the
    plain partial mode and written once in the bound;
    ``scaled_dot_product_attention`` on the same view of the rank's
    slots. The detail gives the split pass's and the merge's device ms
    apart, the pass, its head table's entries, and the K / V bytes the
    split grid reads (each entry reads its KV head's valid rows; a row
    with no valid slot in the normal mode reads its V rows in the merge)
    beside the bound's (each KV head read once)."""
    from repro_torch.kernels import flash_decode
    from repro_torch.kernels.msgs_fused import sm_count
    call = lambda: flash_decode.flash_decode(*args, **kw)
    plain = lambda: flash_decode.flash_decode_plain(*args, **kw)
    out = call()
    partial = bool(kw.get("partial"))
    if partial:
        errs = check_partial("flash_decode partial timing operands", out,
                             plain(), args[0].dtype)
    else:
        errs = (check_close("flash_decode timing operands", out, plain(),
                            tolerance(args[0].dtype, None)),)
    entry = {"name": "flash_decode_partial" if partial else "flash_decode",
             "route": "cuda", "source": "src/repro_torch/csrc/flash_decode.cu",
             "replaces": "src/repro/kernels/flash_decode.py:69",
             "launches": launches, "max_abs_err": max(errs),
             **kernel_times(call, plain, K5_KERNELS)}
    kv_heads = kw.get("kv_heads")
    library = sdpa_call(*args, kv_heads=kv_heads)
    entry["library_ms"] = None if library is None else cuda_ms(library, 11, 20)
    bound = flash_decode_bound(*args, out, kv_heads=kv_heads)
    entry.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
    q, k, v, valid = args[:4]
    table = flash_decode.launch_table(q, k, v, kv_heads)
    length, n_splits = flash_decode.decode_splits(
        q.shape[0], len(table), 1, k.shape[1], sm_count(q.device))
    by = entry["by_kernel"] or {}
    empty_rows = 0 if partial else int((~valid.any(1)).sum())
    grid_kv_bytes = (len(table) * bound["valid_slots"] * 2 + empty_rows
                     * q.shape[1] * k.shape[1]) * q.shape[2] * k.element_size()
    return entry, dict(bound, shape=[list(t.shape) for t in args],
                       dtype=str(args[0].dtype), kernels=list(K5_KERNELS),
                       kv_heads=None if kv_heads is None else list(kv_heads),
                       split_pass=k5_pass(q, k, v), table_entries=len(table),
                       split_pass_ms=sum(t for n, t in by.items()
                                         if n != "flash_decode_merge_kernel")
                       if by else None,
                       merge_ms=by.get("flash_decode_merge_kernel"),
                       grid_kv_bytes=grid_kv_bytes,
                       split_len=length, splits=n_splits,
                       **({"max_abs_err_output": errs[0],
                           "max_abs_err_lse": errs[1]} if partial else {}))


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


def lm_times(lm, families, tp):
    """K5 on the served path's first decode call (and its operands in
    float32), on hymba-1.5b's first served decode call and on a full cache
    in bf16 and float32, K4 on minitron-4b's
    MLP-up products (prefill and decode, bf16 and int8 + scale, prefill in
    float32), one decode step at B = 4 and one 512-token prefill."""
    import torch
    from repro_torch.models.decoder import decode_step, init_cache, prefill
    cfg, params, dev = lm["cfg"], lm["params"], lm["tokens"].device
    k5, d5 = k5_entry(*lm["k5_call"], lm["launches"]["flash_decode"]
                      + families["launches"] + tp["launches"])
    gen = torch.Generator().manual_seed(SEED + 4)
    keep = ("ms", "ms_source", "by_kernel", "profile_calls", "call_ms",
            "plain_ms", "library_ms", "max_abs_err")
    # hymba-1.5b: 25 query heads over 5 KV heads at Dh 64 (the tensor-core
    # pass, one block per group of 5), window 1,024 in most layers
    e, bd = k5_entry(*families["k5_call"], families["launches"])
    d5["hymba_served"] = {k: e[k] for k in keep + ("launches", "bound_ms",
                                                    "bound_by")} | bd
    # minitron-8b at tp 16: rank 1's first decode call, its 2 query heads
    # over the one KV head they read, in place in its cache of all 8
    e, bd = k5_entry(*tp["k5_call"], tp["launches"])
    d5["tp_rank"] = {k: e[k] for k in keep + ("launches", "bound_ms",
                                               "bound_by")} | bd
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


def phase_times(serve, serve_w, train, lm, stream, families, tp):
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
        d2w, **{k: k2w[k] for k in ("ms", "ms_source", "by_kernel",
                                     "profile_calls", "call_ms",
                                     "plain_ms", "max_abs_err", "launches",
                                     "bound_ms", "bound_by")})
    # ... and the stream path's: the first decoder layer of the int8 run's
    # last frame, on the staged table the frame's update rewrote in place
    args, _ = stream["int8_k2_calls"][0]
    k2s, d2s = k2_entry(args[0], args[1:7], stream["int8_launches"])
    detail["msgs_decode"]["int8_stream"] = dict(
        d2s, **{k: k2s[k] for k in ("ms", "ms_source", "by_kernel",
                                     "profile_calls", "call_ms",
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

    lm_kernels, lm_detail, lm_timing = lm_times(lm, families, tp)
    kernels += lm_kernels
    detail.update(lm_detail)
    # K5's partial mode: rank 0's first call of the long_500k decode at
    # (data, model) = (4, 1), hymba's global layer 0 on 131,072 slots
    k5p, detail["flash_decode_partial"] = k5_entry(
        *tp["k5_partial_call"], tp["partial_launches"])
    kernels.append(k5p)

    step_ms, step = train_step_ms(train)
    times = {"train_step_ms_b2": step_ms["captured"],
             "train_step_ms_b2_eager": step_ms["eager"],
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
        "msgs_decode_backward": train["replay"]["kernels"][K2_BWD_POINTS],
        "flash_decode": lm_k5["flash_decode_mma_kernel"]
        + lm_k5["flash_decode_split_kernel"], "matmul": 0}
    emit("times", kernels=detail,
         library_note={"msgs_*": LIBRARY_NOTE,
                       "flash_decode": "F.scaled_dot_product_attention with "
                                       "enable_gqa=True and the boolean mask",
                       "flash_decode_partial": "the same call on the rank's "
                                               "slots (it returns no lse)",
                       "matmul": "torch.matmul (bf16)"},
         **times, forward_profile=serve_profile(serve, "auto"),
         forward_profile_1024=serve_profile(serve_w, "cuda_windowed"),
         train_step_profile=forward_profile(step),
         train_launches_per_step=train["replay"],
         profiler_misses=PROFILER_MISSES, profiler_entries=PROFILER_ENTRIES,
         launches_per_forward=per_forward,
         lm=lm_timing,
         peaks={"hbm_bytes_per_s": HBM_BYTES_PER_S,
                "f32_flop_per_s": F32_FLOP_PER_S,
                "bf16_flop_per_s": BF16_FLOP_PER_S})
    return kernels


# --------------------------------------------------------------------------
# distributed: the band-sharded encoder, EP, the compressed all-reduce, and
# a world of NCCL ranks (the sharded train step, reshard)
# --------------------------------------------------------------------------

DIST_ARCH = "deformable-detr-defa"
DIST_BATCH = 2                   # images through the banded stack
DIST_BANDS = (2, 4)
DIST_FP32_TOL = 2e-4             # one float32 block against one card
DIST_EP_ARCH = "olmoe-1b-7b"
DIST_EP_TP = (2, 4)
DIST_EP_TOKENS = (4, 512)        # (B, S): rows split over data 2
DIST_PSUM_RANKS = 4
DIST_PSUM_NUMEL = 1 << 20
DIST_TRAIN_BATCH = 4             # the sharded step: minitron-4b, 2 layers
DIST_TRAIN_SEQ = 128
DIST_MAX_WORLD = 4
DIST_RANK_TIMEOUT_S = 600
# The six-block bf16 stacks against one card (``encoder_apply``, whose
# blocks promote to float32 after the first attention, as the
# reference's do with float32 reference points): the two round in other
# places, and with INT12 each band quantizes on its own amax (the
# reference's band-local scales) where one card quantizes on the
# image's. Either moves roundings and PAP picks, and six blocks amplify
# that: a CPU rehearsal at a 40 x 60 pyramid gave a median of 3.2-3.5
# bf16 steps of the output with and without INT12, and a max of
# 0.28-0.34 (outputs are LayerNorm'd, |out| up to ~5). Limits: the median
# at most 8 bf16 steps (2^-7 relative, each element against its own
# value), and the max under 1.0, far below a run-away block (errors of
# the outputs' own size).
DIST_STACK_MEDIAN_ULPS = 8
DIST_STACK_MAX = 1.0


def dist_geometry(n_bands, batch, device, gen):
    """The full-width padded pyramid at ``n_bands``: band-major inputs of
    the banded stack and level-major ones of the single card."""
    import torch
    from repro_torch.configs.detr_family import CONFIGS
    from repro_torch.core.distributed_msdeform import (band_reorder,
                                                       pad_levels_to_bands)
    from repro_torch.launch.detr_cells import band_major_refs, padded_geometry
    acfg = CONFIGS[DIST_ARCH]
    n_in = sum(h * w for h, w in acfg.level_shapes)
    x = torch.randn((batch, n_in, 256), generator=gen).to(device)
    xp, padded = pad_levels_to_bands(x, acfg.level_shapes, n_bands)
    assert padded == padded_geometry(acfg.level_shapes, n_bands,
                                     acfg.encoder.attn.range_narrow)[0]
    n_pad = xp.shape[1]
    pos = (torch.randn((n_pad, 256), generator=gen) * 0.1).to(device)
    refs = band_major_refs(padded, n_bands, batch, device)
    xb, _, inv = band_reorder(xp, padded, n_bands)
    inv_t = torch.as_tensor(inv, device=device)
    return dict(padded=padded, xb=xb, pos=pos, refs=refs, xp=xp,
                pos_lm=pos[inv_t], refs_lm=refs[:, inv_t], inv=inv_t)


def dist_encoder(enc, gen, device):
    """Random encoder params with offset weights drawn too (the init
    zeroes them, which would leave every offset on its ring)."""
    import torch
    from repro_torch.core.encoder import init_encoder
    params = init_encoder(enc, gen, device)
    for blk in params["blocks"]:
        a = blk["attn"]
        a["offs_w"] = (torch.randn(a["offs_w"].shape, generator=gen)
                       * 0.05).to(device=device, dtype=a["offs_w"].dtype)
    return params


def dist_stack_check(device, n_bands, enc, label, gen, fp32):
    """The banded stack on ``n_bands`` in-process bands against the
    single-card encoder (``encoder_apply``, torch_gather, FWP off) on the
    same padded pyramid. In bf16 the reference points stay float32, as
    the reference's banded cell takes them, so the single card's blocks
    promote to float32 after the first attention where the banded stack
    stays in bf16; with INT12 each band quantizes on its own amax."""
    import dataclasses
    import torch
    from repro_torch.core.encoder import encoder_apply
    from repro_torch.distributed.collectives import CommStats, InProcessMesh
    from repro_torch.launch.detr_cells import build_banded_detr_stack
    mesh = InProcessMesh((1, n_bands), ("data", "model"))
    stack = build_banded_detr_stack(DIST_ARCH, mesh, DIST_BATCH, enc_cfg=enc)
    params = dist_encoder(enc, gen, device)
    geo = dist_geometry(n_bands, DIST_BATCH, device, gen)
    xb, xp = geo["xb"].to(enc.dtype), geo["xp"].to(enc.dtype)
    pos, pos_lm = geo["pos"].to(enc.dtype), geo["pos_lm"].to(enc.dtype)
    single_cfg = dataclasses.replace(enc, attn=stack.attn_cfg)
    single = lambda: encoder_apply(params, single_cfg, xp, pos_lm,
                                   geo["refs_lm"], geo["padded"],
                                   backend="torch_gather")[0]
    stats = CommStats()
    with torch.no_grad():
        banded = lambda st=None: stack.fn(params, xb, pos, geo["refs"], st)
        got = banded(stats)[:, geo["inv"]]
        want = single()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if not torch.isfinite(got).all():
            raise AssertionError(f"distributed {label}: banded output not finite")
        rec = {"bands": n_bands, "blocks": enc.n_blocks,
               "dtype": str(enc.dtype).replace("torch.", ""),
               "act_bits": enc.attn.act_bits,
               "against": "encoder_apply",
               "max_abs_err": float(err.max()),
               "median_abs_err": float(err.median())}
        if fp32:
            rec["limit"] = {"rtol": DIST_FP32_TOL, "atol": DIST_FP32_TOL}
            check_close(f"distributed {label}", got, want,
                        {"rtol": DIST_FP32_TOL, "atol": DIST_FP32_TOL})
        else:
            w = want.float().abs()
            ulps = err / torch.exp2(torch.floor(torch.log2(
                w.clamp(min=2 ** -100))) - 7)          # bf16: 8 significant bits
            rec["median_bf16_steps"] = float(ulps.median())
            rec["p90_bf16_steps"] = float(torch.quantile(
                ulps.flatten()[::max(1, ulps.numel() // (1 << 22))], 0.9))
            rec["differing_share"] = float((err > 0).float().mean())
            rec["max_abs_out"] = float(w.max())
            rec["limit"] = {"median_bf16_steps": DIST_STACK_MEDIAN_ULPS,
                            "max_abs_err": DIST_STACK_MAX}
            if not (rec["median_bf16_steps"] <= DIST_STACK_MEDIAN_ULPS
                    and rec["max_abs_err"] <= DIST_STACK_MAX):
                raise AssertionError(f"distributed {label}: {rec}")
            rec["banded_ms"] = wall_stats(banded, n=5)["median_ms"]
            rec["single_card_ms"] = wall_stats(single, n=5)["median_ms"]
    # bytes one rank handed to the collectives, per block and image
    item = torch.empty((), dtype=enc.dtype).element_size()
    rec["sent_bytes_per_block_image"] = stats.rank_bytes(0) / enc.n_blocks / DIST_BATCH
    rec["sent_by_op"] = stats.sent.get(0, {})
    return rec, geo, stack, item


def dist_comm_formula(padded, n_bands, ranges, item):
    from repro_torch.core.distributed_msdeform import band_comm_pixels, halo_levels
    px = band_comm_pixels(padded, n_bands, ranges)
    return {"halo_levels": halo_levels(padded, n_bands, ranges),
            "pixels": px, "formula_bytes": px * 256 * item,
            "all_gather_pyramid_bytes": sum(hp * w for hp, w in padded) * 256 * item}


def dist_ep_check(device, tp, gen):
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.distributed.collectives import InProcessMesh
    from repro_torch.models import layers as L
    cfg = get_config(DIST_EP_ARCH)
    p = L.moe_init(cfg, gen, device=device)
    b, s = DIST_EP_TOKENS
    x = torch.randn((b, s, cfg.d_model), generator=gen, device=device).to(cfg.dtype)
    mesh = InProcessMesh((2, tp), ("data", "model"))
    with torch.no_grad():
        with acts.activation_policy(mesh, "data"):
            out, aux = L.moe_apply(p, cfg, x)
        want, _ = L.moe_apply(p, cfg, x)
        halves = [L.moe_apply(p, cfg, xx)[1] for xx in x.chunk(2)]
    tol = tolerance(torch.bfloat16, None)
    err = check_close(f"distributed EP tp {tp}", out, want, tol)
    aux_want = (halves[0] + halves[1]) / 2
    aux_err = abs(float(aux) - float(aux_want))
    if aux_err > 1e-6 * abs(float(aux_want)):
        raise AssertionError(f"distributed EP tp {tp}: aux {float(aux)} vs "
                             f"{float(aux_want)}")
    return {"tp": tp, "mesh": [2, tp], "experts": cfg.n_experts,
            "d_model": cfg.d_model, "tokens": [b, s], "max_abs_err": err,
            "limit": tol, "aux": float(aux), "aux_abs_err": aux_err,
            "aux_limit": "rtol 1e-6 against the mean of each data shard's"}


def dist_psum_run(mesh_factory, g_rows):
    """The compressed psum of rows ``g_rows`` (one per rank) over a "pod"
    axis of that many in-process ranks, two rounds."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.optim.compress import compressed_psum_body
    mesh = mesh_factory(len(g_rows))

    def make(rank, ctx):
        def body():
            g = g_rows[rank]
            o1, r1, q1 = yield from compressed_psum_body(ctx, g, "pod", 8,
                                                         torch.zeros_like(g))
            o2, r2, q2 = yield from compressed_psum_body(ctx, g, "pod", 8, r1)
            return o1, r1, q1, o2, q2
        return body()
    return C.run_in_process(make, mesh)


def dist_psum_check(outs, g_rows):
    import torch
    exact = torch.stack(g_rows).mean(0)
    scale = max(float(g.abs().max()) for g in g_rows) / 127.0
    o1, r1, q1, o2, q2 = outs[0]
    err1 = float((o1 - exact).abs().max())
    e1 = float((o1 - exact).abs().mean())
    e2 = float(((o1 + o2) / 2 - exact).abs().mean())
    agree = all(torch.equal(o[0], o1) and torch.equal(o[3], o2) for o in outs)
    if not (err1 <= 1.1 * scale and e2 <= e1 + 1e-7 and agree):
        raise AssertionError(f"distributed compressed psum: max err {err1} vs "
                             f"1.1 x {scale}; mean err {e1} -> {e2}; ranks "
                             f"agree {agree}")
    return {"ranks": len(g_rows), "numel": g_rows[0].numel(),
            "max_abs_err": err1, "limit": 1.1 * scale,
            "ef_mean_err": [e1, e2], "ranks_agree": agree,
            "codes_sum": int(sum(int(o[2].sum()) for o in outs))}


def dist_free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_nccl_world(world, scratch):
    """Spawn ``world`` NCCL ranks (``chip_smoke.py --dist-rank``), one per
    card; relays rank 0's lines and returns its result line."""
    port = dist_free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                   MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   LOCAL_RANK=str(r), CHIP_SMOKE_SCRATCH=str(scratch))
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--dist-rank"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_RANK_TIMEOUT_S))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    result = None
    for line in outs[0][0].splitlines():
        print(line, flush=True)
        if line.startswith('{"phase": "distributed_nccl"'):
            result = json.loads(line)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad or result is None:
        for r in bad or [0]:
            sys.stderr.write(f"--- rank {r} ---\n{outs[r][1][-4000:]}\n")
        raise AssertionError(f"NCCL world of {world}: ranks {bad} failed")
    return result


def dist_rank_device(rank):
    """A rank's card and backend: card ``rank``, NCCL."""
    import torch
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    return device, "nccl"


def dist_rank_main():
    """One NCCL rank (``--dist-rank``): the banded layer, the sharded train
    step, reshard (in memory and through the checkpoint store), the
    compressed psum and (world > 1) EP on the wire, each against its
    single-card counterpart on rank 0; rank 0 prints the result line."""
    import dataclasses
    import datetime
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.checkpoint.store import (load_checkpoint, reshard,
                                              restore_into, save_checkpoint)
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.detr_family import CONFIGS
    from repro_torch.core.distributed_msdeform import msdeform_attn_banded
    from repro_torch.core.msdeform_attn import msdeform_attn_apply
    from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
    from repro_torch.distributed import act_sharding as acts
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import (named_sharding_tree,
                                                  spec_placements)
    from repro_torch.models import layers as L
    from repro_torch.optim.adamw import OptConfig, tree_leaves, tree_unflatten
    from repro_torch.optim.compress import compressed_psum_body
    from repro_torch.train.step import (
        build_sharded_train_step, build_train_step, local_batch,
        make_train_state, place_train_state, spec_leaves,
        train_state_shardings)

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device, backend = dist_rank_device(rank)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{os.environ['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=datetime.timedelta(minutes=5),
        **({"device_id": device} if device.type == "cuda" else {}))
    res = {"world": world, "backend": dist.get_backend()}
    mesh_of = lambda shape, names=("data", "model"): init_device_mesh(
        device.type, shape, mesh_dim_names=names)

    # --- the banded layer: one float32 block, one band per rank ------------
    enc = CONFIGS[DIST_ARCH].encoder
    attn = dataclasses.replace(enc.attn, act_bits=None, weight_bits=None,
                               dtype=torch.float32, fwp_mode="off")
    enc = dataclasses.replace(enc, attn=attn, n_blocks=1, dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    params = dist_encoder(enc, gen, device)["blocks"][0]["attn"]
    geo = dist_geometry(world, DIST_BATCH, device, gen)
    mesh = mesh_of((1, world))
    spec = (None, "model", None)
    ctx = C.rank_context(mesh)
    mine = lambda t: t[C.local_slices(spec, t.shape, ctx.size, ctx.index)]
    q = geo["xb"] + geo["pos"][None]
    stats = C.CommStats()
    with torch.no_grad():
        out = msdeform_attn_banded(params, attn, mine(q), mine(geo["refs"]),
                                   mine(geo["xb"]), geo["padded"], mesh,
                                   stats=stats)
        parts = [torch.empty_like(out) for _ in range(world)]
        dist.all_gather(parts, out.contiguous())
        got = torch.cat(parts, dim=1)[:, geo["inv"]]
        want, _ = msdeform_attn_apply(
            params, dataclasses.replace(attn, backend="torch_gather"),
            q[:, geo["inv"]], geo["refs_lm"], geo["xp"], geo["padded"])
    err = check_close("distributed NCCL banded", got, want,
                      {"rtol": DIST_FP32_TOL, "atol": DIST_FP32_TOL})
    res["banded"] = {"bands": world, "max_abs_err": err,
                     "limit": DIST_FP32_TOL,
                     "sent_bytes_per_image": stats.rank_bytes(rank) / DIST_BATCH,
                     **dist_comm_formula(geo["padded"], world,
                                         attn.range_narrow, 4)}
    del params, geo, q, out, parts, got, want

    # --- the sharded train step: minitron-4b's widths, 2 layers ------------
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=LM_TRAIN_LAYERS)
    opt = OptConfig(lr=LM_TRAIN_LR, warmup_steps=0, total_steps=10)
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=DIST_TRAIN_SEQ,
                           global_batch=DIST_TRAIN_BATCH, seed=0)
    batch = synth_token_batch(data, 0, device=device)
    state = make_train_state(cfg, torch.Generator(device=device).manual_seed(SEED),
                             device=device)
    single = build_train_step(cfg, opt, capture=False)(state, batch)
    p_single, loss_single = single[0].params, float(single[1]["loss"])
    del single
    tshape = {1: (1, 1), 2: (2, 1)}.get(world, (2, world // 2))
    mesh_a = mesh_of(tshape)
    specs = train_state_shardings(cfg, mesh_a, state)
    placed = place_train_state(state, specs, mesh_a)
    del state
    lbatch = local_batch(batch, mesh_a)
    lbatch2 = local_batch(synth_token_batch(data, 1, device=device), mesh_a)
    # the eager oracle: two steps from the placed state, on two batches;
    # the first (its one-time costs: communicators, DTensor dispatch
    # caches) against one card's step
    eager = build_sharded_train_step(cfg, opt, mesh_a, specs, capture=False)
    eager_ms = []
    for i, rows in enumerate((lbatch, lbatch2)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new, metrics = eager(placed if i == 0 else eager.state, rows)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
        if i:
            continue
        del placed          # the step holds its own copy
        start = [x.to_local().to("cpu", copy=True) for x in tree_leaves(new)]
        full = tree_unflatten(p_single, [b.full_tensor()
                                         for b in tree_leaves(new.params)])
        agree = accum_agreement(full, p_single, LM_TRAIN_LR)
        loss = float(metrics["loss"])
        loss_rel = abs(loss - loss_single) / abs(loss_single)
        bitwise = all(torch.equal(a, b) for a, b in zip(tree_leaves(full),
                                                       tree_leaves(p_single)))
        del full, p_single
    want = [x.to_local().to("cpu", copy=True) for x in tree_leaves(new)]
    want_metrics = {k: v.to("cpu", copy=True) for k, v in metrics.items()}
    # captured: its standing state a copy of the eager one's (then the
    # eager state goes: two states and a graph pool beside the parent's
    # held weights are what the card holds); the first call warms up and
    # captures; the eager state after the first step is copied in and
    # the graph replayed on the second batch, held bitwise to the eager
    # second step
    step = build_sharded_train_step(cfg, opt, mesh_a, specs)
    step.adopt(eager.state)
    del eager, new, metrics
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(step.state, lbatch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        for x, b in zip(tree_leaves(step.state), start):
            x.to_local().copy_(b)
    new, metrics = step(step.state, lbatch2)
    agreement = replay_agreement([x.to_local() for x in tree_leaves(new)],
                                 want)
    agreement["metrics_bitwise"] = all(torch.equal(metrics[k].cpu(), v)
                                       for k, v in want_metrics.items())
    agreement["held"] = agreement["held"] and agreement["metrics_bitwise"]
    del want, start
    placements_ok = all(
        tuple(x.placements) == spec_placements(sp, mesh_a)
        for x, sp in zip(tree_leaves(new), spec_leaves(specs)))
    same = all(a is b for a, b in zip(tree_leaves(new),
                                     tree_leaves(step.state)))
    captured = replay_record("distributed sharded step", step,
                             lambda: step(step.state, lbatch2), eager_ms,
                             first_ms, agreement)
    res["train_step"] = {"arch": LM_ARCH, "layers": cfg.n_layers,
                         "mesh": list(tshape), "batch": [DIST_TRAIN_BATCH,
                                                         DIST_TRAIN_SEQ],
                         "loss": loss, "loss_single_card": loss_single,
                         "loss_rel_err": loss_rel,
                         "loss_limit": LM_ACCUM_LOSS_RTOL,
                         "params": agree, "bitwise_single_card": bitwise,
                         "placements_as_specs": placements_ok,
                         "same_dtensors_returned": same,
                         "placements": sorted({str(tuple(x.placements))
                                               for x in tree_leaves(new)}),
                         "step_ms": eager_ms[0], "second_step_ms": eager_ms[1],
                         "captured": captured}
    if not (agree["held"] and loss_rel <= LM_ACCUM_LOSS_RTOL and placements_ok
            and same):
        raise AssertionError(f"distributed sharded step: {res['train_step']}")

    # --- reshard the trained state onto another mesh (in memory) ----------
    rshape = {1: (1, 1), 2: (1, 2)}.get(world, (world, 1))
    mesh_b = mesh_of(rshape)
    specs_b = train_state_shardings(cfg, mesh_b, new)
    moved = reshard(new, named_sharding_tree(specs_b, mesh_b))
    same = all(torch.equal(a.full_tensor(), b.full_tensor())
               for a, b in zip(tree_leaves(new), tree_leaves(moved)))
    del moved, new, metrics, step
    # ... and through the checkpoint store (minitron-4b's SMOKE config)
    scfg = get_smoke_config(LM_ARCH)
    sstate = make_train_state(scfg, torch.Generator(device=device).manual_seed(1),
                              device=device)
    sspecs = train_state_shardings(scfg, mesh_a, sstate)
    ckpt = os.path.join(os.environ["CHIP_SMOKE_SCRATCH"], f"ckpt_w{world}")
    save_checkpoint(ckpt, 1, place_train_state(sstate, sspecs, mesh_a))
    _, loaded = load_checkpoint(ckpt)
    restored = reshard(restore_into(sstate, loaded), named_sharding_tree(
        train_state_shardings(scfg, mesh_b, sstate), mesh_b))
    stored = all(torch.equal(a.full_tensor(), b)
                 for a, b in zip(tree_leaves(restored), tree_leaves(sstate)))
    res["reshard"] = {"from": list(tshape), "to": list(rshape),
                      "trained_state_bitwise": same,
                      "checkpoint_bitwise": stored}
    if not (same and stored):
        raise AssertionError(f"distributed reshard: {res['reshard']}")

    # --- the compressed psum on the wire, against the same ranks in-process
    gen = torch.Generator(device=device).manual_seed(SEED + 7)
    g_rows = [torch.randn(DIST_PSUM_NUMEL, generator=gen, device=device)
              for _ in range(world)]
    pmesh = mesh_of((world,), ("pod",))
    pctx = C.rank_context(pmesh)
    g = g_rows[rank]
    o1, r1, q1 = C.run_spmd(compressed_psum_body(pctx, g, "pod", 8,
                                                 torch.zeros_like(g)), pmesh)
    local = dist_psum_run(lambda n: C.InProcessMesh((n,), ("pod",)), g_rows)
    res["compressed_psum"] = {
        "ranks": world, "bitwise_in_process": bool(
            torch.equal(o1, local[rank][0]) and torch.equal(q1, local[rank][2])
            and torch.equal(r1, local[rank][1]))}
    if not res["compressed_psum"]["bitwise_in_process"]:
        raise AssertionError(f"distributed NCCL psum: {res['compressed_psum']}")

    # --- EP on the wire: one olmoe layer, the experts over every rank -----
    if world > 1:
        ecfg = get_config(DIST_EP_ARCH)
        gen = torch.Generator(device=device).manual_seed(SEED + 3)
        p = L.moe_init(ecfg, gen, device=device)
        b, s = DIST_EP_TOKENS
        x = torch.randn((b, s, ecfg.d_model), generator=gen,
                        device=device).to(ecfg.dtype)
        emesh = mesh_of((1, world))
        with torch.no_grad():
            with acts.activation_policy(emesh, None):
                out, aux = L.moe_apply(p, ecfg, x)
            want, aux_want = L.moe_apply(p, ecfg, x)
        tol = tolerance(torch.bfloat16, None)
        res["ep"] = {"tp": world, "max_abs_err": check_close(
            "distributed NCCL EP", out, want, tol), "limit": tol,
            "aux_equal": bool(torch.equal(aux, aux_want))}
    # --- TP serving on the wire: deepseek-7b's rank bodies, one per card --
    if world > 1:
        res["tp"] = dist_tp_serve(device, world, mesh_of)
        torch.cuda.empty_cache()
        res["tp_train"] = dist_tp_train(device, world, mesh_of)
        torch.cuda.empty_cache()
        res["long_500k"] = dist_long_decode(device, world, mesh_of)
    dist.barrier()
    if rank == 0:
        emit("distributed_nccl", **res)
    dist.destroy_process_group()


def dist_tp_serve(device, world, mesh_of):
    """One NCCL rank of deepseek-7b served on a (1, world) mesh: the
    serving rank bodies on this card's parameter and cache shards
    (``collectives.run_spmd``), fed the one card's greedy tokens; the
    gathered logits of each prefill and step against this card's one-card
    path (``logit_limits``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.input_specs import serving_program
    from repro_torch.models.registry import get_api
    cfg = get_config(TP_RUNS[0][0])
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                      device=device)
    prompts = seeded_prompts(cfg.vocab_size, TP_NCCL_PROMPTS)
    single = tp_single(cfg, params, prompts, TP_NCCL_STEPS, device)
    mesh = mesh_of((1, world))
    cache = api.init_cache(cfg, len(prompts), TP_CACHE_LEN, device=device)
    pre, pspecs, cspecs = serving_program(cfg, mesh, "prefill", params, cache)
    dec, _, _ = serving_program(cfg, mesh, "decode", params, cache)
    ctx = C.rank_context(mesh)
    is_t = lambda x: isinstance(x, torch.Tensor)
    mine = lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size, ctx.index)]
    rank_params = spec_map(mine, params, pspecs, is_leaf=is_t)
    rank_cache = spec_map(lambda t, sp: mine(t, sp).clone(), cache, cspecs,
                          is_leaf=is_t)
    del cache

    def gathered(logits):
        parts = [torch.empty_like(logits) for _ in range(world)]
        dist.all_gather(parts, logits.contiguous())
        return torch.cat(parts, dim=-1)
    cmps, step_ms = [], []
    with torch.inference_mode():
        for r, prompt in enumerate(prompts):
            toks = torch.as_tensor(prompt[None], device=device)
            logits, _ = C.run_spmd(pre(ctx, rank_params, tp_rows(rank_cache, r),
                                       {"tokens": toks}), mesh)
            cmps.append(logit_limits(gathered(logits)[0], single["prefill"][r]))
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
        for i, tok in enumerate(single["tokens"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = C.run_spmd(dec(ctx, rank_params, rank_cache, tok,
                                       pos + i), mesh)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            cmps.append(logit_limits(gathered(logits), single["decode"][i]))
    bad = [c for c in cmps if not c["held"]]
    if bad:
        raise AssertionError(f"distributed NCCL tp {world}: {bad[0]}")
    return {"model": cfg.name, "tp": world, "prompts": list(TP_NCCL_PROMPTS),
            "decode_steps": TP_NCCL_STEPS,
            "worst_max_abs": max(c["max_abs"] for c in cmps),
            "worst_median_abs": max(c["median_abs"] for c in cmps),
            "tp_step_ms": step_ms, "single_step_ms": single["ms"]}


def dist_long_decode(device, world, mesh_of):
    """One NCCL rank of hymba-1.5b's long_500k decode on a (world, 1)
    mesh, the cache's length split over the data axis: every rank builds
    the whole seeded cache, decodes it as one card, puts back what that
    wrote, then runs the decode rank body (``collectives.run_spmd``) on
    its view of its slots; the logits of each step within
    ``logit_limits`` of its one-card run."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.input_specs import serving_program
    from repro_torch.models.registry import get_api
    cfg, _ = family_config(LONG_ARCH, None)
    params = get_api(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    cache = long_cache(cfg, device)
    saved = long_saved(cache)
    single = long_single(cfg, params, cache, device)
    long_restore(cache, saved)
    del saved
    mesh = mesh_of((world, 1))
    body, pspecs, cspecs = serving_program(cfg, mesh, "decode", params, cache,
                                           shard_len=True)
    ctx = C.rank_context(mesh)
    is_t = lambda x: isinstance(x, torch.Tensor)
    mine = lambda t, sp: t[C.local_slices(sp, t.shape, ctx.size, ctx.index)]
    rank_params = spec_map(mine, params, pspecs, is_leaf=is_t)
    rank_cache = {n: long_shard(n, mine(t, cspecs[n]))
                  for n, t in cache.items()}
    cmps, step_ms = [], []
    before = flash_decode.LAUNCHES_PARTIAL
    with torch.inference_mode():
        for i, tok in enumerate(single["tokens"]):
            pos = torch.tensor([LONG_CACHE_LEN + i], dtype=torch.int32,
                               device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = C.run_spmd(body(ctx, rank_params, rank_cache, tok, pos),
                                   mesh)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            cmps.append(logit_limits(logits, single["logits"][i]))
    launches = flash_decode.LAUNCHES_PARTIAL - before
    bad = [c for c in cmps if not c["held"]]
    if bad or launches != cfg.n_layers * LONG_STEPS:
        raise AssertionError(f"distributed NCCL long_500k {world}: {bad[:1]}, "
                             f"{launches} partial K5 launches")
    del cache, rank_cache, params
    return {"model": cfg.name, "mesh": [world, 1], "cache_len": LONG_CACHE_LEN,
            "decode_steps": LONG_STEPS, "k5_partial_launches": launches,
            "worst_max_abs": max(c["max_abs"] for c in cmps),
            "worst_median_abs": max(c["median_abs"] for c in cmps),
            "split_step_ms": step_ms, "single_step_ms": single["ms"]}


def dist_tp_train(device, world, mesh_of):
    """One NCCL rank of deepseek-7b (TP_TRAIN_RUNS' depth) trained on a
    (1, world) mesh for TP_NCCL_TRAIN_STEPS steps of the train cell's
    rank body over this card's slices of the state, placed as DTensors
    (``train.step.ShardedTrainStep``): before each step its gradients
    (``grads_rank_body`` on the wire) are held per leaf to the same
    slices of this card's one-card step (``tp_train_run``'s limits),
    after it the loss within TP_TRAIN_LOSS_RTOL. The steps run eager
    (``capture=False``), then captured: the first call warms up and
    captures, then the eager state after the first step is copied in and
    the graph replayed on the second batch, held bitwise to the eager
    second step. Rank 0 reports the worst leaf over all ranks."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import spec_placements
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import (OptConfig, adamw_update, tree_leaves,
                                         tree_unflatten)
    from repro_torch.train.step import (TrainState, _loss_and_grads,
                                        build_sharded_train_step,
                                        grads_rank_body, make_train_state,
                                        spec_leaves)
    arch, depth, _ = TP_TRAIN_RUNS[0]
    cfg, reduced = family_config(arch, depth)
    cfg = dataclasses.replace(cfg, remat=False)
    opt = OptConfig(lr=LM_TRAIN_LR, warmup_steps=0, total_steps=TP_TRAIN_STEPS)
    mesh = mesh_of((1, world))
    cell = build_cell(cfg.name, cfg, ShapeSpec("t", "train", TP_TRAIN_SEQ,
                                               TP_TRAIN_BATCH), mesh, opt)
    sspec, bspec = cell.in_shardings
    grads_body = grads_rank_body(cfg, sspec.params)
    grads_of = _loss_and_grads(cfg, get_api(cfg))
    ctx = C.rank_context(mesh)
    is_t = lambda x: isinstance(x, torch.Tensor)
    cut = lambda tree, specs: spec_map(lambda t, sp: t[C.local_slices(
        sp, t.shape, ctx.size, ctx.index)].clone(), tree, specs, is_leaf=is_t)
    state = make_train_state(cfg, torch.Generator(device=device).manual_seed(
        SEED), device=device)
    mine = cut(state, sspec)
    places = [spec_placements(sp, mesh) for sp in spec_leaves(sspec)]
    placed = TrainState(*tree_unflatten(tuple(mine), [
        DTensor.from_local(t, mesh, pl, run_check=False)
        for t, pl in zip(tree_leaves(tuple(mine)), places)]))
    del mine
    worst = torch.zeros(2, dtype=torch.float64, device=device)
    fulls = tp_train_batches(cfg, device, TP_NCCL_TRAIN_STEPS)
    batches = [cut(b, bspec) for b in fulls]
    eager = build_sharded_train_step(cfg, opt, mesh, sspec, capture=False)
    steps = []
    for i, rows in enumerate(batches):
        loss1, _, grads = grads_of(state.params, fulls[i])
        params, opt_state, _ = adamw_update(state.params, grads, state.opt, opt)
        state = TrainState(params, opt_state, state.step + 1)
        del params, opt_state
        now = placed if i == 0 else eager.state
        with torch.enable_grad():
            _, _, got = C.run_spmd(grads_body(ctx, tree_unflatten(
                now.params, [x.to_local() for x in tree_leaves(now.params)]),
                rows), mesh)
        for g, want, spec in zip(tree_leaves(got), tree_leaves(grads),
                                 spec_leaves(sspec.params)):
            c = grad_limits(g, want[C.local_slices(spec, want.shape, ctx.size,
                                                   ctx.index)])
            if not c["held"]:
                raise AssertionError(f"distributed NCCL tp_train: {c}")
            worst = torch.maximum(worst, torch.tensor(
                [c["max_rel"], c["median_rel"]], dtype=torch.float64,
                device=device))
        del got, grads, now
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = eager(placed if i == 0 else eager.state, rows)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss = float(metrics["loss"])
        if not abs(loss - float(loss1)) <= TP_TRAIN_LOSS_RTOL * abs(float(loss1)):
            raise AssertionError(f"distributed NCCL tp_train step {i}: loss "
                                 f"{loss} vs {float(loss1)}")
        steps.append({"loss": loss, "single_loss": float(loss1),
                      "tp_step_ms": ms})
        if i == 0:          # the state the replay starts from
            start = [x.to_local().to("cpu", copy=True)
                     for x in tree_leaves(eager.state)]
        elif i == 1:
            want_state = [x.to_local().to("cpu", copy=True)
                          for x in tree_leaves(eager.state)]
            want_metrics = {k: v.to("cpu", copy=True)
                            for k, v in metrics.items()}
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    del state, metrics, eager
    torch.cuda.empty_cache()
    # captured: the first call warms up and captures; the eager state after
    # the first step is copied in and the graph replayed on the second
    # batch, held bitwise to the eager second step
    step = build_sharded_train_step(cfg, opt, mesh, sspec)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(placed, batches[0])
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    del placed
    with torch.no_grad():
        for x, b in zip(tree_leaves(step.state), start):
            x.to_local().copy_(b)
    new, metrics = step(step.state, batches[1])
    agreement = replay_agreement([x.to_local() for x in tree_leaves(new)],
                                 want_state)
    agreement["metrics_bitwise"] = all(torch.equal(metrics[k].cpu(), v)
                                       for k, v in want_metrics.items())
    agreement["held"] = agreement["held"] and agreement["metrics_bitwise"]
    del want_state, start
    placements_ok = all(tuple(x.placements) == pl
                        for x, pl in zip(tree_leaves(new), places))
    captured = replay_record(
        f"distributed NCCL tp_train x{world}", step,
        lambda: step(step.state, batches[1]), [s["tp_step_ms"] for s in steps],
        first_ms, dict(agreement, placements_as_specs=placements_ok))
    if not placements_ok:
        raise AssertionError(f"distributed NCCL tp_train: placements {captured}")
    del step, new
    return {"model": cfg.name, "tp": world, "reduced": reduced,
            "tokens": [TP_TRAIN_BATCH, TP_TRAIN_SEQ + 1], "steps": steps,
            "grad_worst_max_rel": float(worst[0]),
            "grad_worst_median_rel": float(worst[1]), "captured": captured}


def phase_distributed(device):
    """In-process ranks on this card at full width (the banded encoder at
    2 and 4 bands, EP at tp 2 and 4, the compressed psum over 4 ranks),
    then a world of one NCCL rank and, with 2 or more cards, one rank per
    card up to 4."""
    import dataclasses
    import torch
    from repro_torch.configs.detr_family import CONFIGS
    from repro_torch.distributed.collectives import InProcessMesh
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    before = kernel_counts()
    enc = CONFIGS[DIST_ARCH].encoder
    enc32 = dataclasses.replace(
        enc, n_blocks=1, dtype=torch.float32,
        attn=dataclasses.replace(enc.attn, act_bits=None, weight_bits=None,
                                 dtype=torch.float32))
    enc16 = dataclasses.replace(enc, attn=dataclasses.replace(
        enc.attn, act_bits=None, weight_bits=None))
    stacks, blocks = [], []
    for n_bands in DIST_BANDS:
        gen = torch.Generator().manual_seed(SEED + n_bands)
        rec, _, _, _ = dist_stack_check(device, n_bands, enc32,
                                        f"1 block f32 {n_bands} bands", gen, True)
        blocks.append(rec)
        rec, geo, stack, item = dist_stack_check(
            device, n_bands, enc, f"6-block bf16 INT12 {n_bands} bands", gen, False)
        rec.update(dist_comm_formula(geo["padded"], n_bands,
                                     stack.attn_cfg.range_narrow, item))
        if rec["sent_bytes_per_block_image"] != rec["formula_bytes"]:
            raise AssertionError(f"distributed bytes: {rec}")
        del geo, stack
        rec["control_no_int12"], _, _, _ = dist_stack_check(
            device, n_bands, enc16, f"6-block bf16 {n_bands} bands", gen, False)
        stacks.append(rec)
    ep = [dist_ep_check(device, tp, torch.Generator(device=device).manual_seed(SEED + tp))
          for tp in DIST_EP_TP]
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    g_rows = [torch.randn(DIST_PSUM_NUMEL, generator=gen, device=device)
              for _ in range(DIST_PSUM_RANKS)]
    psum = dist_psum_check(dist_psum_run(
        lambda n: InProcessMesh((n,), ("pod",)), g_rows), g_rows)
    del g_rows
    gc.collect()            # graphs of earlier phases' steps, and their pools
    torch.cuda.empty_cache()
    counts = counts_since(before)
    worlds = [1] + ([min(torch.cuda.device_count(), DIST_MAX_WORLD)]
                    if torch.cuda.device_count() > 1 else [])
    with tempfile.TemporaryDirectory() as scratch:
        nccl = [dist_nccl_world(w, scratch) for w in worlds]
    emit("distributed", world=max(worlds), modes=["in_process", "nccl"],
         worlds=worlds, banded_block=blocks, banded_stack=stacks, ep=ep,
         compressed_psum=psum, nccl=nccl, kernel_launches=counts,
         seconds=time.perf_counter() - t0)
    return stacks



# --------------------------------------------------------------------------
# dryrun: the dry run's fake traces, and two cells held against the card
# --------------------------------------------------------------------------

# (a) fake traces on the single-pod mesh (16 x 16): (arch, shape, --opt)
DRYRUN_LM_CELLS = (("minitron-4b", "train_4k", False),
                   ("olmoe-1b-7b", "decode_32k", True),   # EP under --opt
                   ("hymba-1.5b", "long_500k", False))
DRYRUN_DETR = "deformable-detr-defa"
# (b) against the card on a mesh of one rank: DETR serve, minitron-4b
# decode_32k and deepseek-7b train_4k at full widths, depth and batch cut
# (the train cell's sequence too)
DRYRUN_LM_LAYERS = 2
DRYRUN_LM_BATCH = 8
DRYRUN_TRAIN_BATCH = 2           # the train cell against the card
DRYRUN_TRAIN_SEQ = 1024
DRYRUN_REPS = 5
# the card's peak against the fake run's: it may not fall more than 1 %
# below (every tensor the fake run counts is allocated for real), and may
# rise 5 % + 256 MiB above it: the fake run does not see what an op
# allocates inside itself (cuBLAS and sort workspaces, K5's split
# partials) nor the allocator's rounding of each block to 512 B
DRYRUN_PEAK_BELOW = 0.01
DRYRUN_PEAK_ABOVE = 0.05
DRYRUN_PEAK_SLACK = 256 * 2 ** 20
DRYRUN_BANDS = 2
REMAT_POLICIES = (("off", {"remat": False}),
                  ("nothing", {"remat": True, "remat_policy": "nothing"}),
                  ("save_comm", {"remat": True, "remat_policy": "save_comm"}))
REMAT_STEPS = 3


def dryrun_summary(res):
    rf, mem = res["roofline"], res["memory"]
    return {"meta": res["meta"], "flops": res["cost"]["flops"],
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"], "temp_bytes": mem["temp_bytes"],
            "peak_bytes_per_chip": mem["peak_bytes_per_chip"],
            "fits": res["fits"]["fits"],
            "collective_bytes": res["collectives"]["total_bytes"],
            "handed_bytes": res["collectives"]["handed_bytes"],
            "by_kind": res["collectives"]["by_kind"],
            "requested": res["collectives"]["requested"],
            **{k: rf[k] for k in ("t_compute_s", "t_memory_s",
                                  "t_collective_s", "roofline_step_s",
                                  "dominant", "useful_flops_ratio")},
            "kernels": res["trace"]["kernels"],
            "planned_for": res["trace"]["planned_for"],
            "trace_s": res["timings"]["trace_s"]}


# what the parent tree's rank bodies asked of the collectives in these
# cells (single pod; ``python -m repro_torch.launch.dryrun --arch
# hymba-1.5b --shape long_500k`` and ``--detr`` on the commit before the
# split cache and the DETR cells' FFN shards): bytes a rank asked of each
# all-gather by axis, its peak; printed beside this run's
DRYRUN_BEFORE = {
    "hymba-1.5b/long_500k": {"all_gather": {"model": 61_722_240,
                                            "data": 1_346_371_584},
                             "peak_bytes_per_chip": 35_392_059_144},
    "deformable-detr-defa/serve": {"all_gather": {"model": 393_984},
                                   "peak_bytes_per_chip": 3_763_194_872},
    "deformable-detr-defa/train": {"all_gather": {"model": 404_808,
                                                  "data": 198_240},
                                   "peak_bytes_per_chip": 80_950_626_340}}
# the split cache's merge gathers (B, Hq, Dh + 1) float32 a layer: under
# 1 MB where the cache's gather asked 1.35 GB
DRYRUN_LONG_DATA_GATHER_MAX = 2 ** 20


def dryrun_fake_cells():
    """(a): each cell traced once on fake tensors on the card, in a fake
    world of 256 ranks; hymba's long_500k asks under a MB of all-gather
    over the data axis, the DETR serve cell none over the model axis."""
    from repro_torch.launch import dryrun
    out = {}
    for arch, shape, opt in DRYRUN_LM_CELLS:
        res = dryrun.run_fake(dryrun.lm_cell(arch, shape, opt), "single")
        out[f"{arch}/{shape}" + ("/opt" if opt else "")] = dryrun_summary(res)
    for kind, kw in (("serve", {"backend": "auto"}), ("train", {}),
                     ("banded", {})):
        res = dryrun.run_fake(dryrun.detr_cell(DRYRUN_DETR, kind, **kw),
                                 "single")
        out[f"{DRYRUN_DETR}/{kind}"] = dryrun_summary(res)
    moe = out["olmoe-1b-7b/decode_32k/opt"]
    if out[f"{DRYRUN_DETR}/serve"]["kernels"] != {"msgs_fused": 6} \
            or moe["kernels"] != {"flash_decode": 16}:
        raise AssertionError(f"dryrun: kernel operators {out}")
    long = out["hymba-1.5b/long_500k"]["requested"]["all_gather"]
    serve = out[f"{DRYRUN_DETR}/serve"]["requested"]
    if long.get("data", 0) >= DRYRUN_LONG_DATA_GATHER_MAX \
            or "all_gather" in serve:
        raise AssertionError(f"dryrun: long_500k asked {long}, the DETR serve "
                             f"cell {serve}")
    for cell, before in DRYRUN_BEFORE.items():
        out[cell]["before"] = before
    return out


# (e) the pure-DP archs' --opt train and prefill cells (single pod), each
# traced on the card and on CPU tensors standing for it, in two child
# the pure-DP ``--opt`` cells traced fake on the single-pod mesh, by the
# card and by the CPU stand-in, each in two ``--opt-fakes`` children that
# run at once (host-only traces; nothing is timed meanwhile); the groups
# balance the traces' times (108 + 16 + 10 + 5 s against 55 + 53 + 22 +
# 3 s on the card's host)
# four groups a device, eight children on the card machine's eight cores:
# the two largest train traces alone, so that no child holds two of them
# (each cell's trace seconds are printed)
DRYRUN_OPT_GROUPS = (
    (("hymba-1.5b", "train_4k"),),
    (("minitron-4b", "train_4k"),),
    (("mamba2-130m", "train_4k"), ("whisper-tiny", "train_4k")),
    (("minitron-4b", "prefill_32k"), ("mamba2-130m", "prefill_32k"),
     ("hymba-1.5b", "prefill_32k"), ("whisper-tiny", "prefill_32k")))
DRYRUN_OPT_TIMEOUT_S = 900
# the parent tree's figures of these cells, every model rank computing
# its data group's whole sequence (``python -m repro_torch.launch.dryrun
# --opt --mesh single`` on the commit before the split, on the card): FLOPs
# and peak per rank; printed beside this run's
DRYRUN_OPT_BEFORE = {                  # cell: (FLOPs, peak bytes) a rank
    "hymba-1.5b/prefill_32k": (645_242_268_489_984, 24_778_611_016),
    "hymba-1.5b/train_4k": (992_636_290_727_936, 44_131_161_292),
    "mamba2-130m/prefill_32k": (14_386_147_418_112, 9_457_857_472),
    "mamba2-130m/train_4k": (69_017_171_656_704, 17_558_028_316),
    "minitron-4b/prefill_32k": (1_187_475_703_726_080, 23_112_169_472),
    "minitron-4b/train_4k": (1_945_310_947_442_688, 99_568_351_444),
    "whisper-tiny/prefill_32k": (14_957_723_948_544, 6_694_352_896),
    "whisper-tiny/train_4k": (23_038_437_359_616, 35_022_767_884),
}
# the split cuts FLOPs per rank at least this many times (whisper-tiny's
# train cell least: its 1,500 frames do not divide 16 and stay whole)
DRYRUN_OPT_FLOPS_CUT = 6


def opt_fakes_child(device_name, group, out):
    """``--opt-fakes DEVICE GROUP OUT``: the fake traces of
    DRYRUN_OPT_GROUPS[GROUP] with the fake tensors on ``DEVICE`` ("cuda"
    or "cpu"), their summaries written to ``OUT`` as JSON."""
    from repro_torch.launch import dryrun
    cells = {}
    for arch, shape in DRYRUN_OPT_GROUPS[int(group)]:
        t0 = time.perf_counter()
        cells[f"{arch}/{shape}"] = dict(dryrun_summary(dryrun.run_fake(
            dryrun.lm_cell(arch, shape, True), "single", device=device_name)),
            trace_s=time.perf_counter() - t0)
    Path(out).write_text(json.dumps(cells))


def dryrun_opt_fakes():
    """(e): the cells traced by the card and by the CPU stand-in, in one
    ``--opt-fakes`` child per group and device, all at once (this process
    waits; nothing is timed meanwhile); the card's equal to the CPU's
    (FLOPs, peak, bytes asked), beside the parent tree's figures
    (DRYRUN_OPT_BEFORE)."""
    t0 = time.perf_counter()
    res = {"cuda": {}, "cpu": {}}
    with tempfile.TemporaryDirectory() as scratch:
        procs = []
        for dev in res:
            for g in range(len(DRYRUN_OPT_GROUPS)):
                out = os.path.join(scratch, f"opt_fakes_{dev}{g}.json")
                with open(out + ".err", "w") as err:  # no pipe to fill up
                    procs.append((dev, out, subprocess.Popen(
                        [sys.executable, str(Path(__file__).resolve()),
                         "--opt-fakes", dev, str(g), out],
                        stdout=subprocess.DEVNULL, stderr=err)))
        try:
            for dev, out, proc in procs:
                proc.wait(timeout=DRYRUN_OPT_TIMEOUT_S)
                if proc.returncode != 0:
                    raise AssertionError(
                        f"dryrun --opt fakes ({dev}): "
                        f"{Path(out + '.err').read_text()[-3000:]}")
                res[dev].update(json.loads(Path(out).read_text()))
        finally:
            for _, _, proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    card, cpu = res["cuda"], res["cpu"]
    keys = ("flops", "argument_bytes", "peak_bytes_per_chip", "requested")
    for cell in card:
        if any(card[cell][k] != cpu[cell][k] for k in keys):
            raise AssertionError(f"dryrun --opt {cell}: card "
                                 f"{[card[cell][k] for k in keys]} vs cpu "
                                 f"{[cpu[cell][k] for k in keys]}")
        flops, peak = DRYRUN_OPT_BEFORE[cell]
        card[cell]["before"] = {"flops": flops, "peak_bytes_per_chip": peak}
        if card[cell]["flops"] * DRYRUN_OPT_FLOPS_CUT > flops:
            raise AssertionError(f"dryrun --opt {cell}: {card[cell]['flops']} "
                                 f"FLOPs a rank, {flops} before")
    return {"cells": card, "cpu_equals_card": list(keys),
            "seconds": time.perf_counter() - t0}


def dryrun_against_card(device):
    """(b): three cells traced fake and run for real on a mesh of one rank:
    argument bytes and FLOPs equal, the card's peak within the stated
    band of the fake run's, the median step at or above the least time
    the card could take (:func:`dryrun_floor`), and the kernels the fake
    run called launched once each per call. The fake run's roofline is
    reported beside it, not held: see :func:`dryrun_floor`."""
    import dataclasses
    import torch
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch import dryrun
    one = ((1, 1), ("data", "model"))
    shape = dataclasses.replace(SHAPES["decode_32k"],
                                global_batch=DRYRUN_LM_BATCH)
    SHAPES_DECODE_BATCH = SHAPES["decode_32k"].global_batch
    train = dataclasses.replace(SHAPES["train_4k"],
                                global_batch=DRYRUN_TRAIN_BATCH,
                                seq_len=DRYRUN_TRAIN_SEQ)
    cells = {f"{DRYRUN_DETR}/serve": dryrun.detr_cell(
                 DRYRUN_DETR, "serve", backend="auto"),
             "minitron-4b/decode_32k": dryrun.lm_cell(
                 "minitron-4b", shape, n_layers=DRYRUN_LM_LAYERS),
             # the train rank body (forward, loss, backward, AdamW)
             "deepseek-7b/train_4k": dryrun.lm_cell(
                 "deepseek-7b", train, n_layers=DRYRUN_LM_LAYERS)}
    reduced = {
        "minitron-4b/decode_32k": {
            "n_layers": [lm_config().n_layers, DRYRUN_LM_LAYERS],
            "global_batch": [SHAPES_DECODE_BATCH, DRYRUN_LM_BATCH]},
        "deepseek-7b/train_4k": {
            "n_layers": [30, DRYRUN_LM_LAYERS],
            "global_batch": [SHAPES["train_4k"].global_batch,
                             DRYRUN_TRAIN_BATCH],
            "seq_len": [SHAPES["train_4k"].seq_len, DRYRUN_TRAIN_SEQ]}}
    out = {}
    for name, make_cell in cells.items():
        fake = dryrun.run_fake(make_cell, None, mesh_shape=one)
        torch.cuda.empty_cache()
        before = kernel_counts()
        real = dryrun.run_real(make_cell, device, reps=DRYRUN_REPS,
                               mesh_shape=one)
        launched = {k: v / real["calls"] for k, v in counts_since(before).items()
                    if v}
        torch.cuda.empty_cache()
        want = fake["memory"]["peak_bytes_per_chip"]
        lo = want * (1 - DRYRUN_PEAK_BELOW)
        hi = want * (1 + DRYRUN_PEAK_ABOVE) + DRYRUN_PEAK_SLACK
        median_ms = statistics.median(real["step_ms"])
        floor = dryrun_floor(real, fake, None if name.startswith(DRYRUN_DETR)
                             else name.split("/")[0])
        rec = {"fake": dryrun_summary(fake), "reduced": reduced.get(name, {}),
               "real_flops": real["flops"],
               "real_argument_bytes": real["argument_bytes"],
               "real_peak_bytes": real["peak_bytes"],
               "peak_ratio": real["peak_bytes"] / want,
               "peak_limits": [lo, hi], "step_ms": real["step_ms"],
               "median_ms": median_ms,
               "roofline_step_ms": fake["roofline"]["roofline_step_s"] * 1e3,
               "floor": floor, "launches_per_call": launched}
        rec["held"] = {
            "argument_bytes": real["argument_bytes"]
            == fake["memory"]["argument_bytes"],
            "flops": real["flops"] == int(fake["cost"]["flops"]),
            "peak": lo <= real["peak_bytes"] <= hi,
            "floor": median_ms >= floor["bound_ms"],
            "launches": launched == {k: float(v) for k, v in
                                     fake["trace"]["kernels"].items()}}
        out[name] = rec
        if not all(rec["held"].values()):
            raise AssertionError(f"dryrun against the card, {name}: {rec}")
    return out


def dryrun_floor(real, fake, arch):
    """The least time the card could take for one call of a cell: its
    arguments read once and its outputs written once over the HBM rate,
    or its FLOPs over the bf16 tensor-core rate, whichever is larger. An
    LM's token embedding is left out of the bytes, since a lookup reads
    only its tokens' rows. The fake run's roofline is no such floor: it
    is the reference's structural estimate, which counts every argument
    as read and written and every temp twice, where a decode step only
    reads its weights (minitron-4b's decode_32k cell ran in 3.19 ms on an
    H100 80GB HBM3 at 700 W, against a roofline of 3.36)."""
    import torch
    embed = 0
    if arch is not None:
        from repro_torch.configs import get_config
        cfg = get_config(arch)
        embed = cfg.vocab_size * cfg.d_model * cfg.dtype.itemsize
    nbytes = real["argument_bytes"] - embed + fake["memory"]["output_bytes"]
    return roofline(nbytes, real["flops"], torch.bfloat16) \
        | {"embed_bytes_left_out": embed}


def dryrun_banded(stacks):
    """(c): the banded cell's fake trace at 2 bands against the bytes the
    in-process ranks handed the collectives (the distributed phase's
    CommStats) and the halo formula, per bf16 block and image."""
    from repro_torch.configs.detr_family import CONFIGS
    from repro_torch.launch import dryrun
    res = dryrun.run_fake(
        dryrun.detr_cell(DRYRUN_DETR, "banded", batch=DIST_BATCH), None,
        mesh_shape=((1, DRYRUN_BANDS), ("data", "model")))
    per = CONFIGS[DRYRUN_DETR].encoder.n_blocks * DIST_BATCH
    sent = res["collectives"]["by_kind"]["collective-permute"]["handed_bytes"]
    stack = next(r for r in stacks if r["bands"] == DRYRUN_BANDS)
    rec = {"bands": DRYRUN_BANDS, "batch": DIST_BATCH,
           "fake_bytes_per_block_image": sent / per,
           "comm_stats_bytes_per_block_image": stack["sent_bytes_per_block_image"],
           "formula_bytes": stack["formula_bytes"],
           "param_gather_bytes": res["collectives"]["by_kind"]
           .get("all-gather", {}).get("handed_bytes", 0)}
    if not rec["fake_bytes_per_block_image"] \
            == rec["comm_stats_bytes_per_block_image"] == rec["formula_bytes"]:
        raise AssertionError(f"dryrun banded bytes: {rec}")
    return rec


def remat_grads(cfg, state, batch):
    """(loss, gradient leaves) of one forward and backward."""
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import value_and_grad
    (loss, _), grads = value_and_grad(get_api(cfg).loss_fn, state.params,
                                      cfg, batch)
    return loss, tree_leaves(grads)


def remat_fake_peak(cfg, batch):
    """Bytes a fake trace of ``remat_grads`` (the dry run's memory
    tracker) holds at its peak above its parameters and batch: the
    forward and backward's prediction of the card's."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels.library import card_stand_in
    from repro_torch.launch.hlo_stats import TraceStats
    from repro_torch.train.step import make_train_state
    with FakeTensorMode(allow_non_fake_inputs=True), card_stand_in():
        fake_batch = {k: torch.empty(v.shape, dtype=v.dtype)
                      for k, v in batch.items()}
        state = make_train_state(cfg, torch.Generator().manual_seed(SEED),
                                 device="cpu")
        stats = TraceStats()
        stats.arguments((state.params, fake_batch))
        with stats:
            remat_grads(cfg, state, fake_batch)
    return int(stats.peak - stats.argument_bytes)


def dryrun_remat(device):
    """(d): lm_train's config (minitron-4b widths, 2 layers, bf16, B 4 x
    256) with remat off, "nothing" and "save_comm", and off once more:
    loss and gradients against the first off run (a leaf may differ only
    where the second off run differs too: the embedding's backward adds
    with atomics); the forward and backward's peak above what was
    allocated before it (each remat policy's below off's, as a fake
    trace predicts), the train step's peak and ms."""
    import dataclasses
    import torch
    from repro_torch.data.tokens import TokenDataConfig, synth_token_batch
    from repro_torch.optim.adamw import OptConfig
    from repro_torch.train.step import build_train_step, make_train_state
    base = lm_train_config()
    data = TokenDataConfig(vocab_size=base.vocab_size, seq_len=LM_TRAIN_SEQ,
                           global_batch=LM_TRAIN_BATCH, seed=SEED)
    batch = synth_token_batch(data, 0, device=device)
    opt = OptConfig(lr=LM_TRAIN_LR, warmup_steps=0, total_steps=10)
    ref_loss = ref_grads = None
    out = {}
    for name, kw in REMAT_POLICIES + (("off_again", {"remat": False}),):
        cfg = dataclasses.replace(base, **kw)
        torch.cuda.empty_cache()
        state = make_train_state(
            cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        loss, grads = remat_grads(cfg, state, batch)
        torch.cuda.synchronize()
        fwd_bwd_peak = torch.cuda.max_memory_allocated()
        if ref_grads is None:
            ref_loss, ref_grads = loss, [g.clone() for g in grads]
        differ = [i for i, (g, w) in enumerate(zip(grads, ref_grads))
                  if not torch.equal(g, w)]
        worst = max((float((g.float() - w.float()).abs().max())
                     for g, w in zip(grads, ref_grads)), default=0.0)
        del grads
        step = build_train_step(cfg, opt, capture=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(REMAT_STEPS + 1):
            t0 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out[name] = {"loss": float(loss),
                     "loss_bitwise": bool(torch.equal(loss, ref_loss)),
                     "grad_leaves_differing": differ,
                     "grad_max_abs_diff": worst,
                     "fwd_bwd_peak_bytes": fwd_bwd_peak,
                     "fwd_bwd_peak_above_start_bytes": fwd_bwd_peak - start,
                     "fwd_bwd_fake_peak_above_start_bytes":
                         remat_fake_peak(cfg, batch),
                     "step_peak_bytes": torch.cuda.max_memory_allocated(),
                     "step_ms": ms[1:],
                     "step_ms_median": statistics.median(ms[1:])}
        del state, step
    noise = set(out["off_again"]["grad_leaves_differing"])
    for name in ("nothing", "save_comm"):
        rec = out[name]
        rec["held"] = rec["loss_bitwise"] and set(
            rec["grad_leaves_differing"]) <= noise and (
            rec["fwd_bwd_peak_above_start_bytes"]
            < out["off"]["fwd_bwd_peak_above_start_bytes"])
        if not rec["held"]:
            raise AssertionError(f"dryrun remat {name}: {out}")
    out["rule"] = ("loss bitwise the off run's; a gradient leaf differs only "
                   "where a second off run differs too; the forward and "
                   "backward's peak above its start below off's")
    return out


def phase_dryrun(device, stacks):
    """The dry run (``repro_torch.launch.dryrun``) on the card: (a) fake
    traces on the single-pod mesh, (b) three cells fake and for real on a
    mesh of one rank, (c) the banded cell's bytes against the in-process
    ranks', (d) remat off / nothing / save_comm on lm_train's config,
    (e) the pure-DP ``--opt`` cells, card and CPU (:func:`dryrun_opt_fakes`)."""
    import torch
    t0 = time.perf_counter()
    # in a fresh interpreter: importing the dry run's modules loads neither
    # JAX nor the fake process group (only a dry run's functions do)
    probe = ("import sys; import repro_torch.launch.dryrun, "
             "repro_torch.launch.hlo_stats, repro_torch.launch.input_specs, "
             "repro_torch.launch.detr_cells; print(sorted(m for m in "
             "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro') "
             "or m.endswith('distributed.fake_pg')))")
    src = str(Path(__file__).resolve().parent / "src")
    loaded = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                            text=True, timeout=120,
                            env=dict(os.environ, PYTHONPATH=src))
    if loaded.returncode != 0 or loaded.stdout.strip() != "[]":
        raise AssertionError(f"dryrun: importing repro_torch.launch loaded "
                             f"{loaded.stdout.strip()} {loaded.stderr[-2000:]}")
    fake = dryrun_fake_cells()
    t_fake = time.perf_counter() - t0
    against = dryrun_against_card(device)
    banded = dryrun_banded(stacks)
    remat = dryrun_remat(device)
    opt = dryrun_opt_fakes()
    torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if loaded:
        raise AssertionError(f"dryrun: the port loaded {loaded}")
    emit("dryrun", fake_single_pod=fake, against_card=against,
         banded=banded, remat=remat, opt_single_pod=opt, fake_seconds=t_fake,
         seconds=time.perf_counter() - t0)



# --------------------------------------------------------------------------
# tp: serving on model-axis shards (the dry run's serving rank bodies)
# --------------------------------------------------------------------------

# (arch, depth cut or None, model-axis sizes, prompt lengths, decode steps)
TP_RUNS = (("deepseek-7b", None, (2, 4), LM_PROMPTS, 8),
           # 32 query heads over 8 KV heads on 16: KV heads replicate and
           # each rank hands K5 the one KV head its 2 query heads read
           ("minitron-8b", None, (16,), (37, 128), 3),
           # 8 experts on 16: every expert on each rank's 2,048 FFN columns
           ("grok-1-314b", 2, (16,), (37, 128), 3))
TP_CACHE_LEN = 1024
TP_NCCL_PROMPTS = (37, 128)
TP_NCCL_STEPS = 2


def tp_rows(cache, r):
    """Row ``r`` of a stacked cache (views: writes reach the cache)."""
    return {k: v[:, r:r + 1] for k, v in cache.items()}


class K5Calls:
    """While active, records the (q, K) shapes of every ``ops.flash_decode``
    call (the wrapper itself still launches and counts) and keeps a copy
    of call ``keep``'s operands."""

    def __init__(self, keep=None):
        self.keep, self.kept = keep, None

    def __enter__(self):
        from repro_torch.kernels import ops
        self.orig, self.shapes = ops.flash_decode, []

        def k5(q, k, v, valid, **kw):
            if len(self.shapes) == self.keep:
                self.kept = ([t.clone() for t in (q, k, v, valid)], dict(kw))
            self.shapes.append((tuple(q.shape), tuple(k.shape)))
            return self.orig(q, k, v, valid, **kw)
        ops.flash_decode = k5
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        ops.flash_decode = self.orig


def tp_single(cfg, params, prompts, steps, device):
    """The one-card path: each prompt prefilled into its row of the cache,
    then ``steps`` greedy decode steps of all rows together; the prefill
    and step logits, the fed tokens and the step times."""
    import torch
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    cache = api.init_cache(cfg, len(prompts), TP_CACHE_LEN, device=device)
    out = {"prefill": [], "decode": [], "tokens": [], "ms": []}
    with torch.inference_mode():
        for r, prompt in enumerate(prompts):
            toks = torch.as_tensor(prompt[None], device=device)
            logits, _ = api.prefill(params, cfg, tp_rows(cache, r),
                                    {"tokens": toks})
            out["prefill"].append(logits[0])
        tok = torch.stack(out["prefill"]).argmax(-1).to(torch.int32)
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
        for i in range(steps):
            out["tokens"].append(tok)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = api.decode_step(params, cfg, cache, tok, pos + i)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["decode"].append(logits)
            tok = logits.argmax(-1).to(torch.int32)
    del cache
    return out


def tp_in_process(cfg, params, prompts, steps, tp, device, tokens):
    """The serving rank bodies (``launch.input_specs.serving_program``) of
    every rank of a (1, tp) mesh in turn on this card, each on its views
    of the parameters and its own cache shard, fed ``tokens`` (the one
    card's greedy tokens): the assembled prefill and step logits, K5's
    calls and launches over the decode steps, times and the peak."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.input_specs import serving_program
    from repro_torch.models.registry import get_api
    from repro_torch.distributed.sharding import tree_map as spec_map
    api = get_api(cfg)
    mesh = C.InProcessMesh((1, tp), ("data", "model"))
    full_cache = api.init_cache(cfg, len(prompts), TP_CACHE_LEN, device=device)
    pre, pspecs, cspecs = serving_program(cfg, mesh, "prefill", params,
                                          full_cache)
    dec, _, _ = serving_program(cfg, mesh, "decode", params, full_cache)
    is_t = lambda x: isinstance(x, torch.Tensor)
    ctxs = [C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
            for r in range(tp)]
    # parameters: views of the one card's; caches: each rank's own shard
    rank_params = [spec_map(lambda t, sp: t[C.local_slices(
        sp, t.shape, c.size, c.index)], params, pspecs, is_leaf=is_t)
        for c in ctxs]
    rank_cache = [spec_map(lambda t, sp: t[C.local_slices(
        sp, t.shape, c.size, c.index)].clone(), full_cache, cspecs,
        is_leaf=is_t) for c in ctxs]
    del full_cache

    def logits_of(outs):
        return torch.cat([o[0] for o in outs], dim=-1)
    out = {"prefill": [], "decode": [], "ms": [], "prefill_ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with torch.inference_mode():
        for r, prompt in enumerate(prompts):
            toks = torch.as_tensor(prompt[None], device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = C.run_in_process(lambda rank, ctx: pre(
                ctx, rank_params[rank], tp_rows(rank_cache[rank], r),
                {"tokens": toks}), mesh)
            torch.cuda.synchronize()
            out["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
            out["prefill"].append(logits_of(outs)[0])
        pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=device)
        before = kernel_counts()
        with K5Calls(keep=1) as k5:          # rank 1's first call
            for i, tok in enumerate(tokens[:steps]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs = C.run_in_process(lambda rank, ctx: dec(
                    ctx, rank_params[rank], rank_cache[rank], tok, pos + i),
                    mesh)
                torch.cuda.synchronize()
                out["ms"].append((time.perf_counter() - t0) * 1e3)
                out["decode"].append(logits_of(outs))
        out["launches"] = counts_since(before)
    out["peak_above_params_bytes"] = torch.cuda.max_memory_allocated() - base
    out["k5_shapes"] = sorted({s for s in k5.shapes})
    out["k5_calls"] = len(k5.shapes)
    out["k5_kept"] = k5.kept
    del rank_cache
    return out


def tp_check(cfg, single, got, tp, steps, picks=None):
    """The in-process ranks' logits against the one card's: each prefill
    and decode step within ``logit_limits`` (MoE: ``routed_limits``, the
    ranks' router picks those of rank 0); K5 launched layers x ranks
    times a step, each call on n_heads / tp query heads."""
    n_attn = cfg.n_layers
    if got["launches"]["flash_decode"] != n_attn * tp * steps:
        raise AssertionError(f"tp {cfg.name} x{tp}: {got['launches']} K5 "
                             f"launches over {steps} steps")
    heads = {q[1] for q, _ in got["k5_shapes"]}
    if heads != {cfg.n_heads // tp if cfg.n_heads % tp == 0 else cfg.n_heads}:
        raise AssertionError(f"tp {cfg.name} x{tp}: K5 query heads {heads}")
    cmps = [logit_limits(g, w) for g, w in zip(got["prefill"],
                                                single["prefill"])]
    for i, (g, w) in enumerate(zip(got["decode"], single["decode"])):
        if picks is None:
            cmps.append(logit_limits(g, w))
        else:
            n = len(picks["single"][i])
            cmps.append(routed_limits(g, w, picks["tp"][i][::tp][:n],
                                      picks["single"][i], i))
    bad = [c for c in cmps if not c["held"]]
    if bad:
        raise AssertionError(f"tp {cfg.name} x{tp}: {bad[0]}")
    return {"worst_max_abs": max(c["max_abs"] for c in cmps),
            "worst_median_abs": max(c["median_abs"] for c in cmps),
            "tol_max_min": min(c["tol_max"] for c in cmps),
            "tol_median_min": min(c["tol_median"] for c in cmps),
            "flips": [f for c in cmps for f in c.get("flips", [])],
            "compared": len(cmps)}


# long_500k: hymba-1.5b uncut (bf16, B 1) decoding on a cache of the
# shape's 524,288 slots split over the data axis, against one card's
# decode on the whole cache
LONG_ARCH = "hymba-1.5b"
LONG_CACHE_LEN = 524_288
LONG_STEPS = 4
# (dtype, depth cut or None, {(data, model) mesh: what it is held to}):
# the length split over 4 data ranks; tensor parallel alone (tp 2, the
# whole cache on each rank); both. In bf16 the split is held to the one
# card and the others reported: at tp 2 hymba's MLP sums two bf16 partial
# products, which over 32 layers moves the median logit past 2^-8 of the
# largest against the one card (0.035 of 4.0 on an NVIDIA H100 80GB HBM3
# at 700 W) and, as a perturbation, against each other. In float32,
# cut to 4 layers (the cache 5.4 GB), every mesh is held to the one card
# within LONG_F32_TOL.
LONG_RUNS = (("bfloat16", None, {(4, 1): "one_card", (1, 2): None,
                                 (2, 2): None}),
             ("float32", 4, {(4, 1): "one_card", (2, 2): "one_card"}))
LONG_F32_TOL = 1e-4                      # of the largest |logit|
LONG_SPLIT = ("k", "v", "kpos")          # the leaves split over the length


def long_cache(cfg, device):
    """A B = 1 cache of LONG_CACHE_LEN slots as if decoded through
    position LONG_CACHE_LEN - 1 (a 500 K-token prefill is out of reach):
    K and V drawn from the seed a layer at a time, ``kpos`` the
    positions 0 .. LONG_CACHE_LEN - 1, the SSD states drawn."""
    import torch
    from repro_torch.models.registry import get_api
    cache = get_api(cfg).init_cache(cfg, 1, LONG_CACHE_LEN, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED + 29)
    for name, t in cache.items():
        if name == "kpos":
            t.copy_(torch.arange(LONG_CACHE_LEN, dtype=torch.int32,
                                 device=device).expand_as(t))
            continue
        for i in range(t.shape[0]):
            t[i].normal_(generator=gen)
    return cache


def long_saved(cache):
    """What LONG_STEPS decode steps from position LONG_CACHE_LEN write
    (slots 0 .. LONG_STEPS - 1 of every layer, the SSD states), copied so
    that every run starts from the same cache."""
    return {n: t[:, :, :LONG_STEPS].clone() if n in LONG_SPLIT else t.clone()
            for n, t in cache.items()}


def long_restore(cache, saved):
    for n, t in cache.items():
        (t[:, :, :LONG_STEPS] if n in LONG_SPLIT else t).copy_(saved[n])


def long_shard(name, view):
    """A rank's cache leaf: its view of the one card's where that is a
    slot range each layer holds contiguously (K, V and kpos at B = 1,
    KV heads whole), else its own copy (the SSD states; KV heads split
    over the model axis)."""
    return view if name in LONG_SPLIT and view[0].is_contiguous() \
        else view.clone()


def long_single(cfg, params, cache, device):
    """One card: LONG_STEPS greedy decode steps from position
    LONG_CACHE_LEN over the whole cache (K5's normal mode); logits, fed
    tokens, step ms, K5 launches."""
    import torch
    from repro_torch.kernels import flash_decode
    from repro_torch.models.registry import get_api
    api = get_api(cfg)
    tok = torch.tensor([SEED + 1], dtype=torch.int32, device=device)
    out = {"logits": [], "tokens": [], "ms": []}
    before = flash_decode.LAUNCHES
    with torch.inference_mode():
        for i in range(LONG_STEPS):
            out["tokens"].append(tok)
            pos = torch.tensor([LONG_CACHE_LEN + i], dtype=torch.int32,
                               device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = api.decode_step(params, cfg, cache, tok, pos)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(logits)
            tok = logits.argmax(-1).to(torch.int32)
    out["k5_launches"] = flash_decode.LAUNCHES - before
    return out


def long_ranks(cfg, params, cache, tokens, mesh_shape, device):
    """The decode rank bodies of a ``mesh_shape`` (data, model) mesh with
    the cache's length split over the data axis
    (``serving_program(..., shard_len=True)``), every rank in turn on this
    card: parameters and the split K / V / kpos as views of the one
    card's (at B = 1 a layer's slot range is contiguous: K5 reads it in
    place), the SSD states each rank's own copy. Fed the one card's
    tokens: assembled logits per step, step ms, K5 launches by mode, the
    shapes of K5's calls, rank 0's first call kept for timing, the peak
    above what was held."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.kernels import flash_decode
    from repro_torch.launch.input_specs import logits_spec, serving_program
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    body, pspecs, cspecs = serving_program(cfg, mesh, "decode", params, cache,
                                           shard_len=mesh_shape[0] > 1)
    ctxs = [C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
            for r in range(mesh.size)]
    is_t = lambda x: isinstance(x, torch.Tensor)
    view = lambda t, sp, c: t[C.local_slices(sp, t.shape, c.size, c.index)]
    rank_params = [spec_map(lambda t, sp: view(t, sp, c), params, pspecs,
                            is_leaf=is_t) for c in ctxs]
    rank_cache = [{n: long_shard(n, view(t, cspecs[n], c))
                   for n, t in cache.items()} for c in ctxs]
    lspec = logits_spec(cfg, mesh, 1)
    out = {"logits": [], "ms": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = (flash_decode.LAUNCHES, flash_decode.LAUNCHES_PARTIAL)
    with torch.inference_mode(), K5Calls(keep=0) as k5:
        for i, tok in enumerate(tokens):
            pos = torch.tensor([LONG_CACHE_LEN + i], dtype=torch.int32,
                               device=device)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = C.run_in_process(lambda r, ctx: body(
                ctx, rank_params[r], rank_cache[r], tok, pos), mesh)
            torch.cuda.synchronize()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            out["logits"].append(C.assemble(
                {r: o[0] for r, o in enumerate(outs)}, lspec,
                (1, cfg.vocab_size), mesh))
    out["launches"] = {"flash_decode": flash_decode.LAUNCHES - before[0],
                       "flash_decode_partial":
                           flash_decode.LAUNCHES_PARTIAL - before[1]}
    out["peak_above_held_bytes"] = torch.cuda.max_memory_allocated() - base
    out["k5_shapes"] = sorted({s for s in k5.shapes})
    out["k5_kept"] = k5.kept
    out["ranks"] = mesh.size
    return out


def long_agreement(got, want, f32):
    """Per step ``logit_limits`` (bf16) or max |d| <= LONG_F32_TOL of the
    largest |logit| (float32), summarized."""
    cmps = [logit_limits(g, w) for g, w in zip(got, want)]
    if f32:
        for c in cmps:
            c["tol_max"] = LONG_F32_TOL * c["max_logit"]
            c["held"] = c["max_abs"] <= c["tol_max"]
    return {"held": all(c["held"] for c in cmps),
            "worst_max_abs": max(c["max_abs"] for c in cmps),
            "worst_median_abs": max(c["median_abs"] for c in cmps),
            "tol_max_min": min(c["tol_max"] for c in cmps),
            "tol_median_min": min(c["tol_median"] for c in cmps),
            "bitwise_steps": sum(c["bitwise_equal"] for c in cmps),
            "compared": len(cmps)}


def long_run(dtype, depth, meshes, device):
    """One config of LONG_RUNS: the one card's decode over the whole
    524,288-slot cache, then the rank bodies of each mesh from the same
    cache and tokens, held as ``meshes`` says; on a split cache every
    attention layer of every rank through K5's partial mode and none
    through its normal mode."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api
    cfg, reduced = family_config(LONG_ARCH, depth)
    cfg = dataclasses.replace(cfg, dtype=getattr(torch, dtype))
    if depth is not None:       # the first and last layers stay global
        cut = (0, depth - 1)
        reduced["global_layers"] = [list(cfg.global_layers), list(cut)]
        cfg = dataclasses.replace(cfg, global_layers=cut)
    f32 = cfg.dtype == torch.float32
    memory_mark()
    t0 = time.perf_counter()
    params = get_api(cfg).init(
        cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    cache = long_cache(cfg, device)
    saved = long_saved(cache)
    held = torch.cuda.memory_allocated()
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.values())
    setup_s = time.perf_counter() - t0
    single = long_single(cfg, params, cache, device)
    if single["k5_launches"] != cfg.n_layers * LONG_STEPS:
        raise AssertionError(f"long_500k one card: {single['k5_launches']} K5 "
                             "launches")
    runs, kept, logits = [], None, {}
    for mesh_shape, held_to in meshes.items():
        long_restore(cache, saved)
        got = long_ranks(cfg, params, cache, single["tokens"], mesh_shape,
                         device)
        logits[mesh_shape] = got["logits"]
        calls = cfg.n_layers * got["ranks"] * LONG_STEPS
        split = mesh_shape[0] > 1
        want = {"flash_decode": 0 if split else calls,
                "flash_decode_partial": calls if split else 0}
        if got["launches"] != want:
            raise AssertionError(f"long_500k {mesh_shape}: K5 launches "
                                 f"{got['launches']}, expected {want}")
        slots = {k[1] for _, k in got["k5_shapes"]}
        if slots != {LONG_CACHE_LEN // mesh_shape[0]}:
            raise AssertionError(f"long_500k {mesh_shape}: K5 read {slots} "
                                 "slots a call")
        vs_single = long_agreement(got["logits"], single["logits"], f32)
        if held_to is not None and not vs_single["held"]:
            raise AssertionError(f"long_500k {dtype} {mesh_shape}: "
                                 f"{vs_single}")
        if split:
            kept = kept or got["k5_kept"]
        runs.append({"mesh": list(mesh_shape), "cache_split": split,
                     "held": held_to is not None, "launches": got["launches"],
                     "k5_calls_shapes": [list(map(list, s))
                                         for s in got["k5_shapes"]],
                     "against_one_card": vs_single,
                     "split_step_ms": got["ms"],
                     "peak_above_held_bytes": got["peak_above_held_bytes"]})
    if (1, 2) in logits and (2, 2) in logits:
        runs[-1]["against_tp2_whole_cache"] = long_agreement(
            logits[(2, 2)], logits[(1, 2)], f32)
    scope = None
    if not f32 and (1, 2) in meshes:
        scope = long_scope_probe(cfg, params, cache, saved, device, dict(
            zip([tuple(r["mesh"]) for r in runs], runs))[(1, 2)], single)
    del cache, saved, params
    memory_mark()
    return {"dtype": dtype, "reduced": reduced, "cache_bytes": cache_bytes,
            "held_bytes": held, "setup_s": setup_s,
            "single_step_ms": single["ms"],
            "single_k5_launches": single["k5_launches"], "runs": runs,
            "serving_scope_probe": scope, "k5_partial_call": kept,
            "seconds": time.perf_counter() - t0}


def long_scope_probe(cfg, params, cache, saved, device, default, single):
    """The bf16 tensor-parallel serve (1, 2) and its one card again, both
    under ``train.step.float32_reductions`` (cuBLAS sums a bf16 GEMM's
    partial products in float32, as the reference's dots accumulate):
    agreement and decode ms beside the default's (``default``, the
    mesh's record, and ``single``, the one card's)."""
    from repro_torch.train.step import float32_reductions
    with float32_reductions():
        long_restore(cache, saved)
        one = long_single(cfg, params, cache, device)
        long_restore(cache, saved)
        got = long_ranks(cfg, params, cache, one["tokens"], (1, 2), device)
    scoped = long_agreement(got["logits"], one["logits"], False)
    return {"mesh": [1, 2], "default": default["against_one_card"],
            "float32_reductions": scoped,
            "within_logit_limits": {"default": default["against_one_card"][
                "held"], "float32_reductions": scoped["held"]},
            "single_step_ms": {"default": single["ms"],
                               "float32_reductions": one["ms"]},
            "tp_step_ms": {"default": default["split_step_ms"],
                           "float32_reductions": got["ms"]}}


def long_context(device):
    """hymba-1.5b at long_500k on this card (LONG_RUNS): B 1, LONG_STEPS
    tokens from position LONG_CACHE_LEN on the cache split over the data
    axis, against one card's decode on the whole cache."""
    runs = [long_run(dtype, depth, meshes, device)
            for dtype, depth, meshes in LONG_RUNS]
    # the bf16 run's first split call (hymba's global layer 0) is timed
    kept = [r.pop("k5_partial_call") for r in runs][0]
    return {"model": LONG_ARCH, "batch": 1, "cache_len": LONG_CACHE_LEN,
            "decode_steps": LONG_STEPS, "start_pos": LONG_CACHE_LEN,
            "runs": runs, "k5_partial_call": kept,
            "partial_launches": sum(m["launches"]["flash_decode_partial"]
                                    for r in runs for m in r["runs"]),
            "tolerance": "bf16: logit_limits per step (max 2^-4, median 2^-8 "
                         "of the largest |logit|); float32: max 1e-4 of the "
                         "largest |logit|; meshes with held false reported"}


def phase_tp(device):
    """Serving on model-axis shards on this card: TP_RUNS through the
    serving rank bodies on in-process ranks, each against the one-card
    path on the same weights and tokens; K5 launched on each rank's heads;
    the per-step and prefill times of both. Then long_500k on a cache
    split over the data axis (:func:`long_context`). With 2 or more cards
    the NCCL world of ``phase_distributed`` ran the same bodies one rank
    per card (``distributed_nccl``'s ``tp`` and ``long_500k``)."""
    import torch
    from repro_torch.models.registry import get_api
    t0 = time.perf_counter()
    rows, launches, first_call = [], 0, None
    for arch, depth, tps, prompt_lens, steps in TP_RUNS:
        cfg, reduced = family_config(arch, depth)
        memory_mark()
        params = get_api(cfg).init(
            cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
        param_bytes = sum(t.numel() * t.element_size()
                          for _, t in leaf_paths(params))
        prompts = seeded_prompts(cfg.vocab_size, prompt_lens)
        moe = cfg.family == "moe"
        with RouterPicks() as sp:
            single = tp_single(cfg, params, prompts, steps, device)
        picks_single = tp_split_picks(sp.picks, len(prompts), steps, cfg)
        for tp in tps:
            with RouterPicks() as rp:
                got = tp_in_process(cfg, params, prompts, steps, tp, device,
                                    single["tokens"])
            picks = {"single": picks_single, "tp": tp_split_picks(
                rp.picks, len(prompts), steps, cfg, tp)} if moe else None
            cmp = tp_check(cfg, single, got, tp, steps, picks)
            launches += got["launches"]["flash_decode"]
            if first_call is None and cfg.n_kv_heads % tp:
                first_call = got["k5_kept"]         # a replicated-KV block
            rows.append({"model": cfg.name, "tp": tp, "mesh": [1, tp],
                         "reduced": reduced, "dtype": str(cfg.dtype),
                         "param_bytes": param_bytes, "prompts": list(prompt_lens),
                         "decode_steps": steps, "agreement": cmp,
                         "k5_launches": got["launches"]["flash_decode"],
                         "k5_calls_shapes": [list(map(list, s))
                                             for s in got["k5_shapes"]],
                         "launches": got["launches"],
                         "tp_step_ms": got["ms"], "single_step_ms": single["ms"],
                         "tp_prefill_ms": got["prefill_ms"],
                         "peak_above_params_bytes": got["peak_above_params_bytes"]})
        del params, single
    memory_mark()
    long = long_context(device)
    kept = long.pop("k5_partial_call")
    emit("tp", runs=rows, k5_launches=launches, long_500k=long,
         tolerance="logit_limits (max 2^-4, median 2^-8 of the largest "
                   "|logit|) per prefill and decode step; MoE rows whose "
                   "router set flipped (first flip's gap < 1e-3): median only",
         seconds=time.perf_counter() - t0)
    return {"launches": launches, "k5_call": first_call,
            "k5_partial_call": kept,
            "partial_launches": long["partial_launches"]}


def tp_split_picks(picks, n_prompts, steps, cfg, tp=1):
    """The router records of the decode steps (after the prompts'
    prefills), one list per step."""
    if cfg.family != "moe":
        return None
    per_call = cfg.n_layers * tp
    decode = picks[n_prompts * per_call:]
    return [decode[i * per_call:(i + 1) * per_call] for i in range(steps)]


# --------------------------------------------------------------------------
# tp_train: one train step on model-axis shards (in-process ranks)
# --------------------------------------------------------------------------

# (arch, layers kept, tp degrees): full widths in bf16, depth cut
TP_TRAIN_RUNS = (("deepseek-7b", 4, (2, 4)),
                 # 8 KV heads on 16 ranks: wk / wv replicate, read in part
                 ("minitron-8b", 2, (16,)),
                 # 64 experts on 4 ranks: expert parallel
                 ("olmoe-1b-7b", 2, (4,)))
TP_TRAIN_BATCH = 4
TP_TRAIN_SEQ = 512               # 513 tokens a row: 512 predicted
TP_TRAIN_STEPS = 2               # eager steps, each held to one card's;
                                 # then the first replayed (3 before)
TP_NCCL_TRAIN_STEPS = 2
# per leaf: the gradient's max |d| <= 2^-4 and median <= 2^-8 of the
# largest |g| (bf16 products summed in another order and split over the
# ranks, as logit_limits); the loss within 2^-7 relative
TP_TRAIN_GRAD_MAX = 2 ** -4
TP_TRAIN_GRAD_MEDIAN = 2 ** -8
TP_TRAIN_LOSS_RTOL = 2 ** -7
# a leaf outside those against its float32 gradient (``grad_limits``):
# the ranks add one bf16 rounding per partial product, so their distance
# may exceed the one card's by a few roundings
TP_TRAIN_F32_MEDIAN = 1.5
TP_TRAIN_F32_MAX = 4.0


def tp_train_batches(cfg, device, steps):
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 21)
    return [{"tokens": torch.randint(0, cfg.vocab_size,
                                     (TP_TRAIN_BATCH, TP_TRAIN_SEQ + 1),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
            for _ in range(steps)]


GRAD_CHUNK = 1 << 26             # elements per slice of a leaf compared


def err_stats(got, ref):
    """(max, median) of |got - ref| in float32, and whether ``got`` is
    finite, a slice of GRAD_CHUNK elements at a time: a 1 G-element leaf
    (minitron-8b's embedding) compared whole would take several times its
    size again. The median (the upper middle element) by bisection on
    counts."""
    import torch
    a, b = got.reshape(-1), ref.reshape(-1).to(got.device)
    n = a.numel()

    def errs():
        for i in range(0, n, GRAD_CHUNK):
            yield (a[i:i + GRAD_CHUNK].float() - b[i:i + GRAD_CHUNK].float()).abs()
    finite = all(bool(torch.isfinite(a[i:i + GRAD_CHUNK]).all())
                 for i in range(0, n, GRAD_CHUNK))
    top = max(float(e.max()) for e in errs())
    k = n // 2                              # elements strictly below it
    lo, hi = 0.0, top
    for _ in range(40):
        mid = 0.5 * (lo + hi)
        if sum(int(torch.count_nonzero(e <= mid)) for e in errs()) > k:
            hi = mid
        else:
            lo = mid
    return top, hi, finite


def grad_limits(got, want, median_only=False, truth=None):
    """Per leaf: max and median |d| of the gradient against the one
    card's, as fractions of its largest |g|, held to TP_TRAIN_GRAD_MAX /
    TP_TRAIN_GRAD_MEDIAN (the median only where ``median_only``). A leaf
    outside them is held to its float32 gradient ``truth`` instead: bf16
    rounding moves the one card's own gradient from the float32 one by
    as much (olmoe-1b-7b at 2 layers: 0.9-1.7 % of the largest |g| in
    median, my CPU probe), so the ranks' may lie no further from it than
    TP_TRAIN_F32_MEDIAN x (median) and TP_TRAIN_F32_MAX x (max) the one
    card's."""
    w = want.reshape(-1)
    scale = max([float(w[i:i + GRAD_CHUNK].float().abs().max())
                 for i in range(0, w.numel(), GRAD_CHUNK)] + [1e-30])
    top, med, finite = err_stats(got, want)
    out = {"max_rel": top / scale, "median_rel": med / scale}
    out["held"] = finite and med <= TP_TRAIN_GRAD_MEDIAN * scale \
        and (median_only or top <= TP_TRAIN_GRAD_MAX * scale)
    if out["held"] or truth is None:
        return out
    tp_max, tp_med, _ = err_stats(got, truth)
    one_max, one_med, _ = err_stats(want, truth)
    out["against_f32"] = {"tp_max_rel": tp_max / scale,
                          "tp_median_rel": tp_med / scale,
                          "one_card_max_rel": one_max / scale,
                          "one_card_median_rel": one_med / scale}
    out["held"] = finite and tp_med <= TP_TRAIN_F32_MEDIAN * one_med \
        and (median_only or tp_max <= TP_TRAIN_F32_MAX * one_max)
    return out


# --------------------------------------------------------------------------
# the multi-rank train steps as CUDA graphs: ``train.step.InProcessTrainStep``
# (every rank of an in-process mesh in turn, one graph) and
# ``ShardedTrainStep`` (one NCCL rank a process)
# --------------------------------------------------------------------------

STEP_REPLAYS = 3                 # replays timed after the one held to eager
# a captured step's ``CommStats`` holds its first call of each key (the
# warm-up): a replay runs no Python, so no byte count here comes from one


def ms_summary(ms):
    """Median, p10 and p90 of host-clock samples (below 10 samples p10 and
    p90 are the least and the largest)."""
    s = sorted(ms)
    lo, hi = (statistics.quantiles(s, n=10)[0::8] if len(s) >= 10
              else (s[0], s[-1]))
    return {"n": len(s), "median_ms": statistics.median(s), "p10_ms": lo,
            "p90_ms": hi}


# the cells whose captured step may differ from the eager one, by the
# rule each is held to instead of bitwise: their backward sums with
# atomics (torch.gather's backward is a scatter_add), in an order that
# changes from run to run
REPLAY_NOT_BITWISE = {
    # a token whose route then flips moves its whole share of a leaf from
    # one expert to another: the max is no rounding, the median holds
    # (``grad_limits`` holds a step whose router flipped so)
    "olmoe-1b-7b": "median",
    # the sampling backward's scatter_add; no route to flip
    "deformable-detr-defa": "change",
}


def change_limits(got, want, old, median_only=False):
    """A floating leaf of a replayed step (``got``) against the eager
    step's (``want``), both one step from ``old``, held by the leaf's
    change over the step: |got - want| less one rounding of the leaf's
    dtype at want (eps x |want|: the parameters are stored rounded), as a
    fraction of the largest |want - old|, within TP_TRAIN_GRAD_MAX (max;
    not where ``median_only``) and TP_TRAIN_GRAD_MEDIAN (median): the
    moments' change is a scaled gradient, the parameters' an AdamW step
    of them."""
    import torch
    eps = torch.finfo(want.dtype).eps
    dev = got.device
    g, w, o = got.float(), want.to(dev).float(), old.to(dev).float()
    scale = max(float((w - o).abs().max()), 1e-30)
    e = ((g - w).abs() - eps * w.abs()).clamp_(min=0)
    top, med = float(e.max()), float(e.reshape(-1).median())
    return {"max_rel": top / scale, "median_rel": med / scale,
            "held": bool(torch.isfinite(g).all())
            and (median_only or top <= TP_TRAIN_GRAD_MAX * scale)
            and med <= TP_TRAIN_GRAD_MEDIAN * scale}


def replay_agreement(got, want, before=None, rule="bitwise"):
    """A replayed step's state (leaves on the card) against the eager
    step's from the same state (``want``, its leaves on the host): equal
    leaf by leaf (``rule`` "bitwise"), which every deterministic cell is
    held to. The cells of REPLAY_NOT_BITWISE give their rule and
    ``before``, the state both steps started from (on the host): a
    differing floating leaf is held by its change over the step
    (:func:`change_limits`; "median": the median only); an integer leaf
    (the step counts) must be equal."""
    import torch
    differing, held = [], True
    worst = {"max_rel": 0.0, "median_rel": 0.0}
    n = 1 << 22                 # elements a slice: beside a step's graph
    #                             pool the card may hold little more
    for i, (g, w) in enumerate(zip(got, want)):
        a, b = g.reshape(-1), w.reshape(-1)
        if all(torch.equal(a[j:j + n], b[j:j + n].to(a.device))
               for j in range(0, a.numel(), n)):
            continue
        differing.append(i)
        if rule == "bitwise" or not g.is_floating_point():
            held = False
            continue
        try:
            c = change_limits(g, w, before[i], rule == "median")
        except torch.OutOfMemoryError:      # then on the host
            c = change_limits(g.cpu(), w, before[i], rule == "median")
        held = held and c["held"]
        worst = {k: max(worst[k], c[k]) for k in worst}
    out = {"rule": rule, "bitwise": not differing, "leaves": len(got),
           "leaves_differing": len(differing), "held": held}
    if differing:
        out.update(first_differing=differing[:8], worst=worst)
    return out


def replay_profile(call):
    """One call of a captured step that replays under the profiler: the
    device's busy ms and idle share, its kernels, the host's graph and
    kernel launches, pageable host-to-device copies."""
    dev, cpu, wall = profile(call)
    busy = sum(_device_us(e) for e in dev) / 1e3
    count = lambda evts, frag: sum(e.count for e in evts if frag in e.key)
    return {"wall_ms": wall, "device_busy_ms": busy,
            "idle_share": None if wall <= 0 else max(0.0, 1 - busy / wall),
            "device_kernels": sum(e.count for e in dev),
            "cudaGraphLaunch": count(cpu, "cudaGraphLaunch"),
            "cudaLaunchKernel": count(cpu, "cudaLaunchKernel"),
            "htod_pageable": count(dev, "Memcpy HtoD (Pageable")}


def check_replayed(label, rec):
    """A captured step launches one graph a replay (one key captured) and
    its replay holds against the eager step."""
    if rec["per_replay"]["cudaGraphLaunch"] != 1 or rec["graphs"] != 1 \
            or not rec["replay_vs_eager"]["held"]:
        raise AssertionError(f"{label}: captured step {rec}")


def replay_record(label, step, call, eager_ms, first_ms, agreement):
    """A captured step's record after its replay was held to the eager
    step (``agreement``): STEP_REPLAYS more replays of ``call`` timed
    (host clock to a synchronize) beside the eager steps' and the first
    call's (warm-up and capture) ms, one replay profiled, its graphs and
    their pool, and the peak allocated over the replays (a replay
    allocates from its pool, reserved before it)."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(STEP_REPLAYS):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    prof = replay_profile(call)
    rec = {"eager_step_ms": ms_summary(eager_ms),
           "replayed_step_ms": ms_summary(ms), "first_call_ms": first_ms,
           "eager_ms": list(eager_ms), "replayed_ms": ms,
           "per_replay": prof, "idle_share_at_median": max(
               0.0, 1 - prof["device_busy_ms"] / statistics.median(ms)),
           "graphs": len(step.graphs),
           "graph_pool_bytes": graph_pool_bytes(step.graphs),
           "peak_allocated_bytes": peak, "replay_vs_eager": agreement}
    check_replayed(label, rec)
    return rec


def captured_vs_eager(label, body, mesh, n_state, initial, batches,
                      before=None, after=None, rule="bitwise"):
    """A train cell's in-place rank ``body`` on in-process ranks, eager and
    captured (``train.step.InProcessTrainStep``), from one state.

    ``initial()`` gives every rank's state arguments (views will do: a
    step copies them into its own); ``batches[i]`` every rank's batch
    arguments of step i, two steps at least, each batch its own. The
    eager oracle (``capture=False``) takes the steps in order,
    ``before(i, states)`` and ``after(i, outputs)`` around each (the
    caller's checks against one card); its states after the first and
    the second step go to the host. Then the captured step: its first
    call, on ``batches[0]``, warms up and captures; the eager state after
    the first step is copied into its standing state and the graph
    replayed on ``batches[1]``, and the state it leaves is held to the
    eager second step's (:func:`replay_agreement`): both are one step
    from the same state, on a batch the capture never saw, so a graph
    that kept anything of its warm-up's batch fails. ``rule``: bitwise,
    loss and metrics too; a cell of REPLAY_NOT_BITWISE gives its own
    (:func:`replay_agreement`).
    :func:`replay_record` times it. Returns the record and the compared
    replay's outputs past the state (its metrics or loss), per rank."""
    import gc
    import torch
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import InProcessTrainStep
    assert len(batches) >= 2, "a replay is held on a batch of its own"
    join = lambda states, rows: [tuple(s) + tuple(b)
                                 for s, b in zip(states, rows)]
    host = lambda tree: [t.to("cpu", copy=True) for t in tree_leaves(tree)]
    eager = InProcessTrainStep(body, mesh, n_state=n_state, capture=False)
    ms, peak = [], 0
    for i, rows in enumerate(batches):
        states = initial() if i == 0 else eager.ranks
        if before is not None:
            before(i, states)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = eager(join(states, rows))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated() - base)
        del states
        if i == 0:          # copies: the eager state moves on in place
            start = host(eager.ranks)
        elif i == 1:
            want = host(eager.ranks)
            want_out = host([o[n_state:] for o in out])
        if after is not None:
            after(i, out)
    del eager, out
    gc.collect()
    torch.cuda.empty_cache()
    step = InProcessTrainStep(body, mesh, n_state=n_state)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(join(initial(), batches[0]))
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        for a, b in zip(tree_leaves(step.ranks), start):
            a.copy_(b)
    out = step(join(step.ranks, batches[1]))
    torch.cuda.synchronize()
    agreement = replay_agreement(tree_leaves(step.ranks), want, start, rule)
    agreement["outputs_bitwise"] = all(
        torch.equal(a.cpu(), b) for a, b in zip(
            tree_leaves([o[n_state:] for o in out]), want_out))
    if rule == "bitwise":   # the loss and metrics too
        agreement["held"] = agreement["held"] and agreement["outputs_bitwise"]
    del want, start
    rec = replay_record(label, step, lambda: step(join(step.ranks,
                                                       batches[1])),
                        ms, first_ms, agreement)
    rec["eager_peak_bytes"] = peak      # above what was allocated before it
    return rec, [o[n_state:] for o in out]


def router_flips(picks_got, picks_want):
    """Tokens whose set of router picks differs between two runs, summed
    over the MoE layers."""
    n = 0
    for (_, ea, _), (_, eb, _) in zip(picks_got, picks_want):
        n += int((ea.sort(-1).values != eb.sort(-1).values).any(-1).sum())
    return n


def tp_train_single(cfg, opt, device):
    """The one card, TP_TRAIN_STEPS steps from the seeded state:
    ``train.step``'s gradients and AdamW (``build_train_step``'s
    operations, AdamW taken leaf by leaf); per step the loss, grad norm, time, the router picks
    (MoE) and the gradients, with the float32 gradients of the same
    parameters, copied to the host (a second copy of the state and its
    moments would not fit beside the ranks' at minitron-8b's 256 K
    vocabulary)."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import (adamw_update, global_norm,
                                         tree_leaves, tree_map, tree_unflatten)
    from repro_torch.train.step import (TrainState, _loss_and_grads,
                                        make_train_state)
    grads_of = _loss_and_grads(cfg, get_api(cfg))
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    grads32_of = _loss_and_grads(cfg32, get_api(cfg32))
    state = make_train_state(cfg, torch.Generator(device=device).manual_seed(
        SEED), device=device)
    out = []
    for batch in tp_train_batches(cfg, device, TP_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with RouterPicks() as rp:
            loss, _, grads = grads_of(state.params, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        # the float32 gradient of the same bf16 parameters (untimed)
        _, _, g32 = grads32_of(tree_map(lambda t: t.float(), state.params),
                               batch)
        g32 = [g.to("cpu") for g in tree_leaves(g32)]
        host = [g.to("cpu") for g in tree_leaves(grads)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # AdamW leaf by leaf (each leaf's update is independent; the global
        # norm clips them all), each old leaf dropped as its new one lands:
        # two whole states would not fit beside what earlier phases hold
        p, g = tree_leaves(state.params), tree_leaves(grads)
        mm, vv = tree_leaves(state.opt["m"]), tree_leaves(state.opt["v"])
        del grads
        gnorm = global_norm(g)
        for j in range(len(p)):
            new_p, new_opt, m = adamw_update(
                [p[j]], [g[j]], {"m": [mm[j]], "v": [vv[j]],
                                 "step": state.opt["step"]}, opt, grad_norm=gnorm)
            p[j], mm[j], vv[j], g[j] = new_p[0], new_opt["m"][0], new_opt["v"][0], None
        torch.cuda.synchronize()
        ms += (time.perf_counter() - t0) * 1e3
        out.append({"ms": ms, "loss": float(loss), "grad_norm": float(gnorm),
                    "grads": host, "grads_f32": g32,
                    "picks": [(None, e, None) for _, e, _ in rp.picks]})
        del g32, g
        state = TrainState(tree_unflatten(state.params, p),
                           {"m": tree_unflatten(state.opt["m"], mm),
                            "v": tree_unflatten(state.opt["v"], vv),
                            "step": new_opt["step"]}, state.step + 1)
        del p, mm, vv
    del state
    return out


def tp_train_run(cfg, tp, opt, device, single):
    """TP_TRAIN_STEPS steps of the train cell's rank bodies of a (1, tp)
    mesh from the seeded state, every rank in turn on this card on its
    own slices: before each step their gradients (``grads_rank_body``,
    assembled) against the one card's (``tp_train_single``), after it
    the loss. The steps are those of the cell's body written in place,
    eager (``InProcessTrainStep(capture=False)``), then captured: its
    first call warms up and captures, the second replays the first step
    from the seeded state again, held to the eager one
    (:func:`captured_vs_eager`)."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_map as spec_map
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train.step import (grads_rank_body, make_train_state,
                                        spec_leaves)
    mesh = C.InProcessMesh((1, tp), ("data", "model"))
    shape = ShapeSpec("t", "train", TP_TRAIN_SEQ, TP_TRAIN_BATCH)
    cell = build_cell(cfg.name, cfg, shape, mesh, opt, in_place=True)
    sspec, bspec = cell.in_shardings
    grads_body = grads_rank_body(cfg, sspec.params)
    is_t = lambda x: isinstance(x, torch.Tensor)
    ctxs = [C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
            for r in range(tp)]
    cut = lambda tree, specs, ctx: spec_map(lambda t, sp: t[C.local_slices(
        sp, t.shape, ctx.size, ctx.index)], tree, specs, is_leaf=is_t)

    def initial():
        """Every rank's views of the seeded state (a step copies them)."""
        state = make_train_state(cfg, torch.Generator(
            device=device).manual_seed(SEED), device=device)
        return [(cut(state, sspec, c),) for c in ctxs]
    state = cell.in_specs[0]                  # meta tensors
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    paths = [p for p, _ in leaf_paths(state.params)]
    shapes = [t.shape for t in tree_leaves(state.params)]
    batches = [[(cut(b, bspec, c),) for c in ctxs]
               for b in tp_train_batches(cfg, device, TP_TRAIN_STEPS)]
    steps, worst = [], {}

    def before(i, states):
        """The ranks' gradients at step i against the one card's."""
        with torch.enable_grad(), RouterPicks() as rp:
            outs = C.run_in_process(lambda r, ctx: grads_body(
                ctx, states[r][0].params, batches[i][r][0]), mesh)
        # rank 0's router calls (every rank routes the same rows alike)
        flips = router_flips(rp.picks[::tp], single[i]["picks"])
        cmps = {}
        for j, (path, spec, shape) in enumerate(zip(
                paths, spec_leaves(sspec.params), shapes)):
            got = C.assemble({r: tree_leaves(o[2])[j] for r, o in
                              enumerate(outs)}, spec, shape, mesh)
            cmps[path] = grad_limits(got, single[i]["grads"][j].to(got.device),
                                     flips > 0, single[i]["grads_f32"][j])
            del got
        del outs
        bad = {p: c for p, c in cmps.items() if not c["held"]}
        if bad:
            raise AssertionError(f"tp_train {cfg.name} x{tp} step {i}: "
                                 f"{next(iter(bad.items()))}")
        for p, c in cmps.items():
            w = worst.setdefault(p, {"max_rel": 0.0, "median_rel": 0.0})
            w["max_rel"] = max(w["max_rel"], c["max_rel"])
            w["median_rel"] = max(w["median_rel"], c["median_rel"])
        steps.append({"held_against_f32": {p: c["against_f32"] for p, c
                                           in cmps.items() if "against_f32" in c},
                      "router_flips": flips, "single_step_ms": single[i]["ms"],
                      "allocated_at_step_bytes": torch.cuda.memory_allocated()})

    def after(i, outs):
        """The step's loss against the one card's."""
        loss, want = float(outs[0][1]["loss"]), single[i]["loss"]
        if not abs(loss - want) <= TP_TRAIN_LOSS_RTOL * abs(want):
            raise AssertionError(f"tp_train {cfg.name} x{tp} step {i}: loss "
                                 f"{loss} vs {want}")
        steps[i].update(loss=loss, single_loss=want,
                        grad_norm=float(outs[0][1]["grad_norm"]),
                        single_grad_norm=single[i]["grad_norm"])

    rec, outs = captured_vs_eager(f"tp_train {cfg.name} x{tp}", cell.body,
                                  mesh, 1, initial, batches, before, after,
                                  rule=REPLAY_NOT_BITWISE.get(cfg.name,
                                                              "bitwise"))
    loss, want = float(outs[0][0]["loss"]), single[1]["loss"]
    if not abs(loss - want) <= TP_TRAIN_LOSS_RTOL * abs(want):
        raise AssertionError(f"tp_train {cfg.name} x{tp} replayed step: loss "
                             f"{loss} vs {want}")
    for s, ms in zip(steps, rec["eager_ms"]):
        s["tp_step_ms"] = ms
    top = max(worst, key=lambda p: worst[p]["max_rel"])
    return {"state_bytes": state_bytes, "steps": steps, "grad_worst": {
        "max_rel": worst[top]["max_rel"], "leaf_of_max": top,
        "median_rel": max(w["median_rel"] for w in worst.values())},
        "captured": dict(rec, replayed_loss=loss),
        "computed_whole": cell.computed_whole}


# the DETR cells on model-axis shards: deformable-detr-defa at the 800 x
# 1333 pyramid, float32, B 2, each rank on its quarter of the encoder
# FFN; the train step cut to 2 of 6 blocks: the in-process ranks hold
# their autograd graphs at once (about 3 GB of float32 activations a
# block per rank at B 2)
DETR_TP_ARCH = "deformable-detr-defa"
DETR_TP_MESHES = ((1, 4), (2, 2))      # (2, 2): the INT12 scale over images
DETR_TP_BATCH = 2
DETR_TP_TRAIN_BLOCKS = 2
DETR_TP_LOSS_RTOL = 1e-4


def detr_tp_inputs(enc, level_shapes, device):
    """Seeded params (offsets drawn too), the pyramid (B, N, 256),
    positions (N, 256) and each pixel's centre as its reference point."""
    import torch
    from repro_torch.launch.detr_cells import band_major_refs
    gen = torch.Generator().manual_seed(SEED + 31)
    params = dist_encoder(enc, gen, device)
    n = sum(h * w for h, w in level_shapes)
    x = torch.randn((DETR_TP_BATCH, n, enc.d_model), generator=gen).to(device)
    pos = (torch.randn((n, enc.d_model), generator=gen) * 0.1).to(device)
    refs = band_major_refs(level_shapes, 1, 1, device)[0].contiguous()
    return params, x, pos, refs


def detr_rank_inputs(cell, mesh, inputs):
    """Each rank's slices of ``inputs`` by the cell's specs (views)."""
    import torch
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.sharding import tree_map as spec_map
    is_t = lambda x: isinstance(x, torch.Tensor)
    out = []
    for r in range(mesh.size):
        ctx = C.RankContext(mesh.coords(r), C.mesh_shape(mesh))
        out.append(tuple(spec_map(lambda t, sp: t[C.local_slices(
            sp, t.shape, ctx.size, ctx.index)], x, sp, is_leaf=is_t)
            for x, sp in zip(inputs, cell.in_shardings)))
    return out


def detr_grads(params, enc, level_shapes, x, pos, refs):
    """One card: the train cell's objective through ``encoder_apply``
    (torch_gather) and its gradient tree."""
    import torch
    from repro_torch.core.encoder import encoder_apply
    from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    with torch.enable_grad():
        out, _ = encoder_apply(live, enc, x, pos, refs, level_shapes,
                               backend="torch_gather")
        loss = torch.mean(torch.square(out - torch.roll(x, 1, dims=1)))
        grads = torch.autograd.grad(loss, tree_leaves(live))
    return loss.detach(), tree_unflatten(params, list(grads))


def tp_detr(device, mesh_shape):
    """The DETR serve and train cells' rank bodies on in-process ranks of
    a ``mesh_shape`` (data, model) mesh (``launch.detr_cells.build_detr_cell``:
    the attention whole, the FFN on each rank's share, the model axis's
    sum; on a data split each rank's images, their INT12 scales the whole
    batch's, ``act_sharding.batch_max``), against
    one card: serve at ``auto`` (K1 in every block) within DEFA's
    agreement limits (median 1e-3, max 0.5 of the LayerNorm'd output),
    the train step's gradients within the train phase's gradient rule
    (calibrated by a one-ulp nudge of the pyramid) and its loss within
    DETR_TP_LOSS_RTOL; launches, step ms of both sides and peaks."""
    import dataclasses
    import torch
    from repro_torch.configs.detr_family import CONFIGS, with_dtype
    from repro_torch.core.encoder import encoder_apply
    from repro_torch.distributed import collectives as C
    from repro_torch.kernels import msgs_fused
    from repro_torch.launch.detr_cells import _loss_body, build_detr_cell
    from repro_torch.models.registry import ModelAPI
    from repro_torch.optim.adamw import (OptConfig, adamw_init, adamw_update,
                                         tree_leaves, tree_unflatten)
    from repro_torch.train.step import grads_rank_body, spec_leaves
    acfg = CONFIGS[DETR_TP_ARCH]
    levels = acfg.level_shapes
    enc = with_dtype(acfg.encoder, torch.float32)
    mesh = C.InProcessMesh(mesh_shape, ("data", "model"))
    memory_mark()
    params, x, pos, refs = detr_tp_inputs(enc, levels, device)
    res = {"model": DETR_TP_ARCH, "mesh": list(mesh_shape), "dtype": "float32",
           "batch": DETR_TP_BATCH, "queries": x.shape[1]}

    def timed(fn):
        """fn's second call: its result, host ms to a synchronize, and
        the peak above what was allocated before it."""
        fn()                                  # warm-up: plans, cuBLAS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, \
            torch.cuda.max_memory_allocated() - base

    # serve: the whole encoder at auto
    cell = build_detr_cell(DETR_TP_ARCH, "serve", mesh, batch=DETR_TP_BATCH,
                           backend="auto", enc_cfg=enc)
    ranks = detr_rank_inputs(cell, mesh, (params, x, pos, refs))
    with torch.no_grad():
        k1 = msgs_fused.LAUNCHES
        (want, _), single_ms, single_peak = timed(lambda: encoder_apply(
            params, enc, x, pos, refs, levels, backend="auto"))
        single_k1 = (msgs_fused.LAUNCHES - k1) / 2      # warm-up and timed
        k1 = msgs_fused.LAUNCHES
        outs, tp_ms, tp_peak = timed(lambda: C.run_in_process(
            lambda r, ctx: cell.body(ctx, *ranks[r]), mesh))
        tp_k1 = (msgs_fused.LAUNCHES - k1) / 2
    got = C.assemble(dict(enumerate(outs)), cell.in_shardings[1],
                     tuple(want.shape), mesh)
    err = (got - want).abs()
    serve = {"blocks": enc.n_blocks, "max_abs": float(err.max()),
             "median_abs": float(err.median()), "largest": float(want.abs().max()),
             "single_k1_launches_per_call": single_k1,
             "k1_launches_per_call": tp_k1,
             "single_ms": single_ms, "tp_ms": tp_ms,
             "single_peak_bytes": single_peak, "tp_peak_bytes": tp_peak}
    if not (torch.isfinite(got).all() and serve["median_abs"] <= 1e-3
            and serve["max_abs"] <= 0.5) or single_k1 != enc.n_blocks \
            or tp_k1 != enc.n_blocks * mesh.size:
        raise AssertionError(f"tp detr serve: {serve}")
    res["serve"] = serve
    del outs, got, want, err, ranks
    # train: the gradients, then the cell's step
    enc2 = dataclasses.replace(enc, n_blocks=DETR_TP_TRAIN_BLOCKS)
    params2 = {"blocks": params["blocks"][:DETR_TP_TRAIN_BLOCKS]}
    memory_mark()
    (loss1, want), grad_ms, grad_peak = timed(
        lambda: detr_grads(params2, enc2, levels, x, pos, refs))
    _, spread = detr_grads(params2, enc2, levels,
                           torch.nextafter(x, torch.full_like(x, math.inf)),
                           pos, refs)
    cell = build_detr_cell(DETR_TP_ARCH, "train", mesh, batch=DETR_TP_BATCH,
                           enc_cfg=enc2)
    api = ModelAPI(*(None,) * len(ModelAPI._fields))._replace(
        loss_body=_loss_body(enc2, levels))
    body = grads_rank_body(enc2, cell.in_shardings[0], api)
    ranks = detr_rank_inputs(cell, mesh, (params2, adamw_init(params2), x,
                                          pos, refs))
    with torch.enable_grad():
        outs, tp_grad_ms, tp_grad_peak = timed(lambda: C.run_in_process(
            lambda r, ctx: body(ctx, ranks[r][0], dict(zip(
                ("x", "pos", "refs"), ranks[r][2:]))), mesh))
    got = [C.assemble({r: tree_leaves(o[2])[i] for r, o in enumerate(outs)},
                      sp, tuple(w.shape), mesh)
           for i, (w, sp) in enumerate(zip(tree_leaves(want),
                                           spec_leaves(cell.in_shardings[0])))]
    rule = gradient_rule(tree_unflatten(want, got), want, spread,
                         "tp detr train gradients")
    del outs, got, spread
    opt = adamw_init(params2)
    _, single_step_ms, _ = timed(lambda: adamw_update(params2, want, opt,
                                                     OptConfig()))
    # the cell's step written in place: eager on two pyramids, then
    # captured (its first call warms up and captures), the second step
    # replayed from the eager state after the first and held to it
    losses = []

    def after(i, outs):
        if i == 0:
            losses.extend(float(o[2]) for o in outs)
    cell = build_detr_cell(DETR_TP_ARCH, "train", mesh, batch=DETR_TP_BATCH,
                           enc_cfg=enc2, in_place=True)
    x2 = torch.randn(x.shape, generator=torch.Generator().manual_seed(
        SEED + 32)).to(device)
    rows = [[r[2:] for r in detr_rank_inputs(cell, mesh, (
        params2, adamw_init(params2), xb, pos, refs))] for xb in (x, x2)]
    captured, _ = captured_vs_eager(
        f"tp detr train {mesh_shape}", cell.body, mesh, 2,
        lambda: [r[:2] for r in ranks], rows, after=after,
        rule=REPLAY_NOT_BITWISE.get(DETR_TP_ARCH, "bitwise"))
    if not all(abs(l - float(loss1)) <= DETR_TP_LOSS_RTOL * abs(float(loss1))
               for l in losses):
        raise AssertionError(f"tp detr train: losses {losses} vs {float(loss1)}")
    res["train"] = {"blocks": enc2.n_blocks, "reduced": {
                        "n_blocks": [enc.n_blocks, enc2.n_blocks]},
                    "gradient_rule": rule, "loss": losses[0],
                    "single_loss": float(loss1),
                    "single_grad_ms": grad_ms, "tp_grad_ms": tp_grad_ms,
                    "single_adamw_ms": single_step_ms,
                    "tp_step_ms": captured["eager_ms"][0],
                    "single_grad_peak_bytes": grad_peak,
                    "tp_grad_peak_bytes": tp_grad_peak,
                    "captured": captured}
    del ranks, rows, want, params, params2, x2
    memory_mark()
    return res


# --------------------------------------------------------------------------
# opt: the pure-DP archs' --opt train and prefill cells on a sequence split
# --------------------------------------------------------------------------

# (arch, depth cut or None): full widths in bf16, minitron-4b, mamba2-130m
# and hymba-1.5b cut in depth, whisper-tiny whole. mamba2 and hymba are
# cut to 2 layers: their four ranks take turns on the host, and each
# train cell runs two eager steps and a capture (mamba2 at its full 24
# layers took 187 s on an H100, of the script's 1,200 s limit)
OPT_RUNS = (("minitron-4b", 2), ("mamba2-130m", 2), ("hymba-1.5b", 2),
            ("whisper-tiny", None))
OPT_MESHES = ((1, 4), (2, 2))
OPT_SEQ = 4096
OPT_TRAIN_BATCH = 8              # grad_accum 4 (whisper 2) x data 2
OPT_PREFILL_BATCH = 4
OPT_F32_LAYERS = 2               # the float32 run: depth 2, on (2, 2)
OPT_F32_SEQ = 1024
OPT_F32_TOL = 1e-4               # of the largest |value|
# a prefill above 2 x attn_chunk (2,048): the blockwise attention, each
# rank's queries offset into the gathered keys
OPT_BLOCKWISE = ("minitron-4b", 2, 8192)
# float32 train runs left out: what the card cannot hold
OPT_F32_NO_TRAIN = {"minitron-4b": "not run in float32: four in-process "
                    "ranks' float32 gathers of the 1.74 G parameters and "
                    "their cotangents do not fit beside one card's (80 GB)"}
# the train cells whose in-process step runs eager only: the graph pool of
# minitron-4b's four ranks (51.2 GB at (1, 4): each rank's 256 K-column
# logits of a microbatch alive at once, 2 GB apiece in float32) beside its
# 17.4 GB standing state and one card's parameters ran out of the card's
# 80 GB in the whole script
OPT_NO_CAPTURE = {"minitron-4b": "eager only: four in-process ranks' graph "
                  "pool (51.2 GB at (1, 4)) beside the standing state and "
                  "one card's parameters does not fit the card (80 GB)"}


def opt_config(arch, depth, kind, dtype=None):
    """The reference's ``--opt`` config (``launch.dryrun._opt_cfg``) of the
    published config cut to ``depth`` layers (its global layers among
    them kept, hymba-1.5b's (0, 15, 31) -> (0,)) and cast to ``dtype``;
    the cut as printed in ``reduced``."""
    import dataclasses
    from repro_torch.launch.dryrun import _opt_cfg
    cfg, reduced = family_config(arch, depth)
    kept = tuple(i for i in cfg.global_layers if i < cfg.n_layers)
    if kept != tuple(cfg.global_layers):
        reduced = dict(reduced, global_layers=[list(cfg.global_layers),
                                               list(kept)])
        cfg = dataclasses.replace(cfg, global_layers=kept)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    cfg, on = _opt_cfg(arch, cfg, kind)
    if not (on and cfg.pure_dp):
        raise AssertionError(f"opt: {arch} {kind} is no pure-DP cell")
    return cfg, reduced


def opt_batch(cfg, b, s, device, train, draw=0):
    """Seeded tokens (s + 1 a row to train) and, for whisper, frames;
    ``draw`` picks another seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(SEED + 41 + draw)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + int(train)),
                                     generator=gen, device=device,
                                     dtype=torch.int32)}
    if cfg.family == "encdec":
        batch["frames"] = torch.randn((b, cfg.enc_seq_len, cfg.d_model),
                                      generator=gen, device=device
                                      ).to(cfg.dtype)
    return batch


def opt_run(cell, mesh, inputs, grad):
    """Every rank of ``mesh`` in turn on this card, each on its slices of
    ``inputs`` by the cell's in-shardings: the cell's body, which enters
    the cell's own policy (``seq_shard``); the ranks' outputs."""
    import torch
    from repro_torch.distributed import collectives as C
    ranks = detr_rank_inputs(cell, mesh, inputs)
    with torch.set_grad_enabled(grad):
        return C.run_in_process(lambda r, ctx: cell.body(ctx, *ranks[r]),
                                mesh)


def opt_timed(fn):
    """fn() once: its result, host ms to a synchronize, and the peak above
    what was allocated before it."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3, \
        torch.cuda.max_memory_allocated() - base


def opt_f32_truth(cfg, params, batch):
    """One card's float32 gradients of the same (bf16) parameters and
    batch, on the host: what ``grad_limits`` holds a bf16 leaf to when it
    falls outside the bf16 rule (one card's own bf16 gradient lies as far
    from it)."""
    import dataclasses
    import torch
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.step import _loss_and_grads
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    b32 = {k: v.float() if v.is_floating_point() else v
           for k, v in batch.items()}
    _, _, g = _loss_and_grads(cfg32, get_api(cfg32))(
        tree_map(lambda t: t.float(), params), b32)
    return [t.to("cpu") for t in tree_leaves(g)]


def opt_arch(arch, depth, device, dtype=None, meshes=OPT_MESHES, seq=None,
             train=True):
    """One arch's ``--opt`` train and prefill cells on each mesh of
    ``meshes`` against one card (:func:`opt_train`, :func:`opt_prefill`)."""
    import torch
    from repro_torch.models.registry import get_api
    seq = seq or OPT_SEQ
    cfg, reduced = opt_config(arch, depth, "train", dtype)
    api = get_api(cfg)
    gen = torch.Generator(device=device).manual_seed(SEED)
    out = {"model": arch, "reduced": reduced, "dtype": str(cfg.dtype),
           "seq": seq, "grad_accum": cfg.grad_accum,
           "remat_policy": cfg.remat_policy}
    params = api.init(cfg, gen, device=device)
    if train:
        out["train"] = opt_train(arch, cfg, device, meshes, seq, params)
    else:
        out["train"] = OPT_F32_NO_TRAIN[arch]
    return opt_prefill(arch, depth, device, dtype, meshes, seq, params, out)


def opt_step_want(p, m, v, lr, bc1, bc2, opt):
    """AdamW's new value of parameter ``p`` from the step's own moments
    ``m`` and ``v``, op for op as ``optim.adamw._leaf_update`` forms it."""
    import torch
    den = torch.div(v, bc2).sqrt_().add_(opt.eps)
    update = torch.div(m, bc1).div_(den)
    p32 = p.to(torch.float32)
    update.add_(torch.mul(p32, opt.weight_decay)).mul_(lr)
    return update.neg_().add_(p32).to(p.dtype)


def opt_train(arch, cfg, device, meshes, seq, params):
    """The train cell's whole step (its ``body`` under its own policy:
    the sequence split, the gradients, AdamW on the ZeRO slices and the
    write-back) from zero moments on each mesh, against one card's
    gradients of the same parameters and batch. After one step a first
    moment is (1 - beta1) x the clipped gradient, so the gradient the
    step used is m / ((1 - beta1) x clip scale): held per leaf by the
    bf16 gradient rule (a leaf outside it against its float32 gradient,
    as ``tp_train`` holds one), float32 within OPT_F32_TOL. The new
    parameters are held to AdamW of the old ones with the step's own
    moments (:func:`opt_step_want`): within one rounding of their dtype.
    The loss and the global norm against one card's."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.registry import get_api
    from repro_torch.optim.adamw import (OptConfig, _update_scalars,
                                         global_norm, tree_leaves, tree_map)
    from repro_torch.train.step import (InProcessTrainStep, TrainState,
                                        _loss_and_grads, spec_leaves)
    f32 = cfg.dtype == torch.float32
    opt = OptConfig(warmup_steps=0)   # lr 3e-4 at once: a step above a bf16
                                      # rounding of most parameters
    batch = opt_batch(cfg, OPT_TRAIN_BATCH, seq, device, True)
    memory_mark()
    (loss1, _, want), single_ms, single_peak = opt_timed(
        lambda: _loss_and_grads(cfg, get_api(cfg))(params, batch))
    norm1 = float(global_norm(want))
    want = [t.to("cpu") for t in tree_leaves(want)]   # off the card meanwhile
    res = {"batch": OPT_TRAIN_BATCH, "single_loss": float(loss1),
           "single_grad_norm": norm1, "single_grad_ms": single_ms,
           "single_grad_peak_bytes": single_peak}
    rtol = OPT_F32_TOL if f32 else TP_TRAIN_LOSS_RTOL
    p_ulp = OPT_F32_TOL if f32 else 2.0 ** -7     # one rounding of p
    truth = None
    n = len(want)
    for d, t in meshes:
        mesh = C.InProcessMesh((d, t), ("data", "model"))
        cell = build_cell(arch, cfg, ShapeSpec("t", "train", seq,
                                               OPT_TRAIN_BATCH), mesh, opt,
                          policy=True, in_place=True)
        # the initial zero moments as stride-0 views: each step copies them
        # into its own standing state (minitron-4b's 14 GB of moments once)
        zero = torch.zeros((), dtype=torch.float32, device=device)
        step0 = torch.zeros((), dtype=torch.int32, device=device)
        state = TrainState(params, {
            "m": tree_map(lambda p: zero.expand(p.shape), params),
            "v": tree_map(lambda p: zero.expand(p.shape), params),
            "step": step0}, step0)
        ranks = detr_rank_inputs(cell, mesh, (state, batch))
        memory_mark()
        checked = {}

        def after(i, outs):
            """The eager first step's gradients, new parameters, loss and
            norm."""
            nonlocal truth
            if i:
                return
            metrics = outs[0][1]
            loss, gnorm = float(metrics["loss"]), metrics["grad_norm"]
            _, scale, _, lr, bc1, bc2 = _update_scalars(
                None, {"step": step0}, opt, gnorm)
            specs = spec_leaves(cell.in_shardings[0])
            whole = lambda i, ref: C.assemble(
                {r: tree_leaves(o[0])[i] for r, o in enumerate(outs)},
                specs[i], tuple(ref.shape), mesh)
            worst = {"max_rel": 0.0, "median_rel": 0.0, "leaf": None}
            params_worst = {"max_rel": 0.0, "bitwise": True}
            outside = {}
            for j, (w, p) in enumerate(zip(want, tree_leaves(params))):
                w = w.to(device)
                m, v = whole(n + j, w), whole(2 * n + 1 + j, w)
                got_p = whole(j, w)
                p_want = opt_step_want(p, m, v, lr, bc1, bc2, opt)
                err = (got_p.float() - p_want.float()).abs()
                lim = p_want.float().abs() * p_ulp
                params_worst["bitwise"] &= bool(torch.equal(got_p, p_want))
                params_worst["max_rel"] = max(params_worst["max_rel"], float(
                    (err / p_want.float().abs().clamp(min=1e-30)).max()))
                if not bool((err <= lim).all()):
                    raise AssertionError(f"opt {arch} {d}x{t} step: parameter "
                                         f"{j} is not AdamW of its moments")
                del v, got_p, p_want, err, lim
                g = m.div_((1 - opt.beta1) * scale)
                if f32:
                    top = float(w.abs().max())
                    e = float((g - w).abs().max())
                    cmp = {"max_rel": e / max(top, 1e-30), "median_rel": 0.0,
                           "held": bool(torch.isfinite(g).all())
                           and e <= OPT_F32_TOL * top}
                    if not cmp["held"]:
                        raise AssertionError(f"opt {arch} {d}x{t} gradient "
                                             f"{j}: {cmp}")
                else:
                    cmp = grad_limits(g, w)
                    if not cmp["held"]:
                        outside[j] = g
                if cmp["max_rel"] >= worst["max_rel"]:
                    worst.update(max_rel=cmp["max_rel"], leaf=j)
                worst["median_rel"] = max(worst["median_rel"],
                                          cmp["median_rel"])
                del g, m, w
            if outside:
                memory_mark()
                truth = truth or opt_f32_truth(cfg, params, batch)
                worst["against_f32"] = {}
                for j, g in outside.items():
                    cmp = grad_limits(g, want[j].to(device),
                                      truth=truth[j].to(device))
                    if not cmp["held"]:
                        raise AssertionError(f"opt {arch} {d}x{t} gradient "
                                             f"{j}: {cmp}")
                    worst["against_f32"][j] = cmp.get("against_f32")
                del outside
            if not abs(loss - float(loss1)) <= rtol * abs(float(loss1)):
                raise AssertionError(f"opt {arch} {d}x{t}: loss {loss} vs "
                                     f"{float(loss1)}")
            if not abs(float(gnorm) - norm1) <= rtol * norm1:
                raise AssertionError(f"opt {arch} {d}x{t}: grad_norm "
                                     f"{float(gnorm)} vs {norm1}")
            checked.update(loss=loss, grad_norm=float(gnorm),
                           grad_worst=worst, params=params_worst)

        # the cell's step written in place: eager on two batches, then
        # captured (its first call warms up and captures), the second step
        # replayed from the eager state after the first and held to it
        if arch in OPT_NO_CAPTURE:
            eager = InProcessTrainStep(cell.body, mesh, capture=False)
            outs, ms, peak = opt_timed(lambda: eager(ranks))
            after(0, outs)
            del eager, outs
            captured = {"eager_ms": [ms], "eager_peak_bytes": peak,
                        "not_captured": OPT_NO_CAPTURE[arch]}
        else:
            second = detr_rank_inputs(cell, mesh, (state, opt_batch(
                cfg, OPT_TRAIN_BATCH, seq, device, True, draw=1)))
            captured, _ = captured_vs_eager(
                f"opt {arch} {d}x{t}", cell.body, mesh, 1,
                lambda: [r[:1] for r in ranks],
                [[r[1:] for r in ranks], [r[1:] for r in second]],
                after=after, rule=REPLAY_NOT_BITWISE.get(arch, "bitwise"))
            del second
        del ranks, state
        res[f"{d}x{t}"] = dict(checked, tp_step_ms=captured["eager_ms"][0],
                               tp_step_peak_bytes=captured["eager_peak_bytes"],
                               captured=captured)
    del want, truth, batch
    memory_mark()
    return res


def opt_prefill(arch, depth, device, dtype, meshes, seq, params, out):
    """:func:`opt_arch`'s prefill half: the cell's last-position logits on
    each mesh against one card's ``prefill``, into ``out["prefill"]``."""
    import torch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.input_specs import build_cell
    from repro_torch.models.registry import get_api
    f32 = dtype is not None
    cfg, _ = opt_config(arch, depth, "prefill", dtype)
    api = get_api(cfg)
    batch = opt_batch(cfg, OPT_PREFILL_BATCH, seq, device, False)
    memory_mark()
    with torch.no_grad():
        (want, _), single_ms, single_peak = opt_timed(lambda: api.prefill(
            params, cfg, api.init_cache(cfg, OPT_PREFILL_BATCH, seq,
                                        device=device), batch))
    out["prefill"] = {"batch": OPT_PREFILL_BATCH, "single_ms": single_ms,
                      "single_peak_bytes": single_peak}
    for d, t in meshes:
        mesh = C.InProcessMesh((d, t), ("data", "model"))
        cell = build_cell(arch, cfg, ShapeSpec("p", "prefill", seq,
                                               OPT_PREFILL_BATCH), mesh,
                          policy=True)
        cache = api.init_cache(cfg, OPT_PREFILL_BATCH, seq, device=device)
        memory_mark()
        outs, ms, peak = opt_timed(lambda: opt_run(
            cell, mesh, (params, cache, batch), False))
        rows = cell.in_shardings[2]["tokens"][0]
        got = C.assemble({r: o[0] for r, o in enumerate(outs)}, (rows, None),
                         tuple(want.shape), mesh)
        if f32:
            scale = float(want.abs().max())
            err = float((got - want).abs().max())
            cmp = {"max_rel": err / scale, "held": bool(
                torch.isfinite(got).all()) and err <= OPT_F32_TOL * scale}
        else:
            cmp = logit_limits(got, want)
        if not cmp["held"]:
            raise AssertionError(f"opt {arch} {d}x{t} prefill: {cmp}")
        out["prefill"][f"{d}x{t}"] = {"logits": cmp, "tp_ms": ms,
                                      "tp_peak_bytes": peak}
        del outs, got, cache
    del params, want
    memory_mark()
    return out


def opt_cells(device):
    """The reference's ``--opt`` train and prefill cells of the four
    pure-DP archs (OPT_RUNS) on in-process ranks of (1, 4) and (2, 2),
    each rank on its block of its data group's token rows, against one
    card (:func:`opt_arch`): bf16 at S OPT_SEQ, then float32 at
    OPT_F32_LAYERS layers on (2, 2) (OPT_F32_NO_TRAIN: prefill only),
    then OPT_BLOCKWISE's prefill. cuBLAS runs as the port sets it: the
    train path under ``train.step.float32_reductions``, prefill at
    PyTorch's default. No kernel of K1-K5 is on this path (the reference
    computes these cells in plain jnp)."""
    import torch
    from repro_torch.models.registry import get_api
    t0 = time.perf_counter()
    before = kernel_counts()
    runs = []
    for arch, depth in OPT_RUNS:
        t1 = time.perf_counter()
        runs.append(dict(opt_arch(arch, depth, device),
                         seconds=time.perf_counter() - t1))
    f32 = []
    for arch, _ in OPT_RUNS:
        t1 = time.perf_counter()
        f32.append(dict(opt_arch(arch, OPT_F32_LAYERS, device, torch.float32,
                                 meshes=((2, 2),), seq=OPT_F32_SEQ,
                                 train=arch not in OPT_F32_NO_TRAIN),
                        seconds=time.perf_counter() - t1))
    arch, depth, seq = OPT_BLOCKWISE
    t1 = time.perf_counter()
    cfg, reduced = opt_config(arch, depth, "prefill")
    if cfg.attn_impl == "dense" or seq <= 2 * cfg.attn_chunk \
            or seq % cfg.attn_chunk:
        raise AssertionError(f"opt: {arch} at S {seq} attends densely")
    params = get_api(cfg).init(cfg, torch.Generator(device=device)
                               .manual_seed(SEED), device=device)
    blockwise = opt_prefill(arch, depth, device, None, OPT_MESHES, seq,
                            params, {"model": arch, "reduced": reduced,
                                     "seq": seq,
                                     "attn_chunk": cfg.attn_chunk})
    del params
    return {"runs": runs, "float32": f32,
            "blockwise_prefill": dict(blockwise,
                                      seconds=time.perf_counter() - t1),
            "kernel_launches": counts_since(before),
            "seconds": time.perf_counter() - t0}


def phase_tp_train(device):
    """Training on model-axis shards on this card: TP_TRAIN_RUNS, each
    TP_TRAIN_STEPS steps from one seeded state through the train cell's
    rank bodies on in-process ranks, against the one card's step on the
    same batches (``tp_train_run``): the gradients per leaf and the loss
    within their limits. The LM train path launches none of K1-K5. Then
    the DETR serve and train cells on the model axis (:func:`tp_detr`)
    and the ``--opt`` cells (:func:`opt_cells`). Every train cell's step
    runs eager and then as one CUDA graph for all its ranks
    (:func:`captured_vs_eager`)."""
    import dataclasses
    import torch
    from repro_torch.optim.adamw import OptConfig
    t0 = time.perf_counter()
    before = kernel_counts()
    held = memory_mark()[1]                   # what earlier phases hold
    rows = []
    for arch, depth, tps in TP_TRAIN_RUNS:
        cfg, reduced = family_config(arch, depth)
        cfg = dataclasses.replace(cfg, remat=False)
        opt = OptConfig(lr=LM_TRAIN_LR, warmup_steps=0,
                        total_steps=TP_TRAIN_STEPS)
        memory_mark()
        t1 = time.perf_counter()
        single = tp_train_single(cfg, opt, device)
        single_s = time.perf_counter() - t1
        for tp in tps:
            memory_mark()
            t1 = time.perf_counter()
            got = tp_train_run(cfg, tp, opt, device, single)
            rows.append({"seconds": time.perf_counter() - t1,
                         "single_seconds": single_s,
                         "model": cfg.name, "tp": tp, "mesh": [1, tp],
                         "reduced": reduced, "dtype": str(cfg.dtype),
                         "remat": False,
                         "tokens": [TP_TRAIN_BATCH, TP_TRAIN_SEQ + 1], **got})
        del single
    memory_mark()
    launches = counts_since(before)
    detr = {f"{d}x{t}": tp_detr(device, (d, t)) for d, t in DETR_TP_MESHES}
    opt = opt_cells(device)
    emit("tp_train", runs=rows, kernel_launches=launches, detr=detr, opt=opt,
         allocated_before_bytes=held,
         tolerance="per leaf: gradient max |d| <= 2^-4 and median <= 2^-8 "
                   "of the largest |g| of the one card's (median only in a "
                   "step whose MoE router flipped a token); else against "
                   "the float32 gradient: median within 1.5x and max within "
                   "4x the one card's bf16 distance; loss within 2^-7 "
                   "relative; detr: serve median 1e-3 and max 0.5 of the "
                   "one card's output, the train phase's gradient rule, "
                   "loss 1e-4 relative; opt (the cell's whole step): "
                   "bf16 gradients (first moment / ((1 - beta1) x clip)) "
                   "2^-4 / 2^-8 of the largest |g| per leaf, loss and "
                   "grad_norm 2^-7 relative, new parameters within one "
                   "bf16 rounding (2^-7 relative) of AdamW of the step's "
                   "moments, prefill logits logit_limits; float32 "
                   "gradients, loss, grad_norm, parameters and logits "
                   "within 1e-4 of the largest; captured (every train "
                   "cell: InProcessTrainStep): the graph replayed from "
                   "the eager state after step 1 on step 2's batch, its "
                   "state, loss and metrics bitwise the eager step 2's; "
                   "REPLAY_NOT_BITWISE cells (atomics in the backward): "
                   "per leaf |got - want| less one rounding at want, "
                   "median 2^-8 and (the DETR cell; not olmoe-1b-7b, "
                   "whose routes flip) max 2^-4 of the leaf's largest "
                   "change over the step; one graph launch a replay",
         seconds=time.perf_counter() - t0)
    return rows


# --------------------------------------------------------------------------
# host cost of the kernels' wrappers (``--host-cost SRC``)
# --------------------------------------------------------------------------

HOST_COST_STEPS = 50             # eager steps per path (after a warm-up)
HOST_COST_CALLS = 200            # back-to-back wrapper calls, no synchronize


def enqueue_us(fn, calls=HOST_COST_CALLS):
    """Host microseconds per call of ``calls`` back-to-back calls of
    ``fn`` (no synchronize between them: the wrapper's and the
    dispatcher's host work, the device running behind)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return host


def host_cost(device, src):
    """Eager wall clock of one minitron-4b decode step at B = 4 (full
    width, random bf16 weights, a 4096-slot cache; 32 K5 calls) and of
    one 512 px forward at ``auto`` (B = 2; 6 K1 and 6 K2 calls), and the
    host time per wrapper call of K5 and K1 on those paths' operands,
    with the port package under ``src`` (run it for two trees in turns)."""
    import numpy as np
    import torch
    from repro_torch.core.detector import detector_apply, init_detector
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_api
    cfg = lm_config()
    api = get_api(cfg)
    params = api.init(cfg, torch.Generator(device=device).manual_seed(SEED),
                      device=device)
    cache = api.init_cache(cfg, LM_MAX_BATCH, LM_CACHE_LEN, device=device)
    tokens = torch.zeros(LM_MAX_BATCH, dtype=torch.int32, device=device)
    pos = torch.tensor(LM_PROMPTS, dtype=torch.int32, device=device)

    def decode():
        with torch.inference_mode():
            api.decode_step(params, cfg, cache, tokens, pos)
    lm = wall_stats(decode, n=HOST_COST_STEPS)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = torch.randn((LM_MAX_BATCH, cfg.n_heads, cfg.dh), generator=gen,
                    device=device).to(cfg.dtype)
    kv = torch.randn((LM_MAX_BATCH, LM_CACHE_LEN, cfg.n_kv_heads, cfg.dh),
                     generator=gen, device=device).to(cfg.dtype)
    valid = torch.ones((LM_MAX_BATCH, LM_CACHE_LEN), dtype=torch.bool,
                       device=device)
    k5_us = enqueue_us(lambda: ops.flash_decode(q, kv, kv, valid))
    del params, cache, q, kv
    torch.cuda.empty_cache()
    dcfg = slice_config("deformable-detr-defa")
    dparams = init_detector(dcfg, torch.Generator().manual_seed(SEED),
                            device=device)
    x = torch.from_numpy(np.stack(seeded_images(MAX_BATCH))).to(device)

    def forward():
        with torch.inference_mode():
            detector_apply(dparams, dcfg, x, backend="auto")
    det = wall_stats(forward, n=HOST_COST_STEPS)
    from repro_torch.msda.plan import level_shapes_for_resolution
    cpu_gen = torch.Generator().manual_seed(SEED)
    pts, n_pix = synthetic_points(cpu_gen, (MAX_BATCH, 21760, 8, 4),
                                  level_shapes_for_resolution(IMG), device)
    v = torch.randn((MAX_BATCH, n_pix, 8, 32), generator=cpu_gen).to(device)
    k1_us = enqueue_us(lambda: ops.msgs_fused(v, *pts))
    emit("host_cost", src=str(src), lm_decode_step_b4=lm,
         detector_512_forward_b2=det, k5_wrapper_host_us=k5_us,
         k1_wrapper_host_us=k1_us, calls=HOST_COST_CALLS,
         custom_ops=hasattr(torch.ops, "repro_torch")
         and hasattr(torch.ops.repro_torch, "flash_decode"))


# --------------------------------------------------------------------------
# the accuracy phase in a child (``--accuracy``): deterministic algorithms
# --------------------------------------------------------------------------

def accuracy_child(device):
    """``chip_smoke.py --accuracy``: the accuracy phase under
    torch.use_deterministic_algorithms(True), in a child process run with
    CUBLAS_WORKSPACE_CONFIG=:4096:8 (the flag reaches no other phase)."""
    import torch
    torch.use_deterministic_algorithms(True)
    phase_accuracy(device)


def phase_accuracy_deterministic():
    """The accuracy phase in a child process (``--accuracy``) under
    deterministic algorithms, its lines relayed: every such training
    gives one AP, where default algorithms draw it from the encoder's
    scatter-add order."""
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                           "--accuracy"], env=env, capture_output=True,
                          text=True, timeout=900)
    rec = None
    for line in proc.stdout.splitlines():
        print(line, flush=True)
        if line.startswith('{"phase": "accuracy"'):
            rec = json.loads(line)
    if proc.returncode != 0 or rec is None:
        sys.stderr.write(proc.stderr[-6000:])
        raise AssertionError(f"--accuracy child exited {proc.returncode}")
    return rec


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
    child = sys.argv[1:] == ["--train-loop"]
    if sys.argv[1:2] in (["--table-grad-chain"], ["--host-cost"]) \
            and len(sys.argv) == 3:
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
    if sys.argv[1:] == ["--dist-rank"]:
        dist_rank_main()
        return 0
    if sys.argv[1:2] == ["--opt-fakes"] and len(sys.argv) == 5:
        opt_fakes_child(*sys.argv[2:])
        return 0
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    if child:
        train_loop_child(device)
        return 0
    if sys.argv[1:] == ["--accuracy"]:
        accuracy_child(device)
        return 0

    smi = phase_device()
    if sys.argv[1:2] == ["--dist-world"] and len(sys.argv) == 3:
        # only the NCCL world of that many ranks, one per card
        with tempfile.TemporaryDirectory() as scratch:
            dist_nccl_world(int(sys.argv[2]), scratch)
        return 0
    if sys.argv[1:2] == ["--host-cost"] and chain_src is not None:
        phase_build()
        host_cost(device, chain_src)
        return 0
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
    loop = phase_train_loop()
    phase_accuracy_deterministic()
    phase_lm_train(device, loop["lm_fault_tolerant"])
    # before the LM serving phases, whose weights stay held to the end
    phase_tp_train(device)
    lm = phase_lm_serve(device)
    families = phase_lm_families(device)
    stream = phase_stream(device, serve)
    stacks = phase_distributed(device)
    phase_dryrun(device, stacks)
    tp = phase_tp(device)
    emit("capture", detector_512=serve["capture"],
         detector_512_plain=serve["plain_capture"],
         detector_1024=serve_w["capture"], mixed_buckets=mixed,
         lm_decode=lm["capture"], obs_log=serve["obs_log"])
    phase_autotune(device, smi, serve)
    kernels = phase_times(serve, serve_w, train, lm, stream, families, tp)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
