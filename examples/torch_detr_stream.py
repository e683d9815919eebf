"""Streaming-video detection driver of the PyTorch port: temporal
value-cache reuse (port of examples/detr_stream.py).

N concurrent synthetic video sessions stream drifting-scene encoder
memories through :class:`~repro_torch.serve.StreamingDetrEngine`: each
session holds a persistent, incrementally updated value cache — per
frame only the tiles the moving object dirtied are re-projected and
written in place into the table and its decode staging, the FWP keep
decision rides a streaming EMA with keep-mask hysteresis, and the
decoder + heads run one batched forward against the shared cache (K2 on
the card).

  PYTHONPATH=src python examples/torch_detr_stream.py --frames 4 --dry-run [--device cpu]
  PYTHONPATH=src python examples/torch_detr_stream.py --frames 32 --sessions 2
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import msda
from repro_torch.bridge import resolve_device
from repro_torch.core import nn
from repro_torch.core.msdeform_attn import MSDeformAttnConfig
from repro_torch.serve import StreamingDetrEngine
from repro_torch.stream import StreamConfig, drifting_scene

DRY_LEVELS = ((16, 20), (8, 10), (4, 5), (2, 3))
FULL_LEVELS = ((32, 40), (16, 20), (8, 10), (4, 5))


def build_engine(args):
    dev = resolve_device(args.device)
    levels = DRY_LEVELS if args.dry_run else FULL_LEVELS
    d = 64 if args.dry_run else 128
    attn_cfg = MSDeformAttnConfig(
        d_model=d, n_heads=4, fwp_mode="compact", fwp_k=1.0,
        fwp_capacity=0.6, range_narrow=(8.0, 6.0, 4.0, 3.0))
    dec_cfg = msda.MSDADecoderConfig(
        n_layers=3 if args.dry_run else 6,
        n_queries=32 if args.dry_run else 100,
        d_ffn=2 * d)
    gen = torch.Generator().manual_seed(7)
    params = {
        "decoder": msda.init_decoder(dec_cfg, attn_cfg, gen, device=dev),
        "cls_head": nn.linear_init(gen, d, 5, device=dev),
        "box_head": nn.linear_init(gen, d, 4, device=dev),
    }
    scfg = StreamConfig(tile_rows=args.tile_rows,
                        delta_threshold=args.threshold,
                        update_frac=args.update_frac,
                        diff_channel_stride=args.diff_stride)
    engine = StreamingDetrEngine(attn_cfg, dec_cfg, params, levels,
                                 max_sessions=args.sessions,
                                 backend=args.backend, stream_cfg=scfg,
                                 device=dev)
    return engine, levels, d


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=2)
    ap.add_argument("--backend", default=None,
                    choices=msda.available_backends() + ["auto"])
    ap.add_argument("--tile-rows", type=int, default=1)
    ap.add_argument("--threshold", type=float, default=1e-4)
    ap.add_argument("--update-frac", type=float, default=0.3)
    ap.add_argument("--diff-stride", type=int, default=4,
                    help="probe every s-th feature channel when diffing "
                         "tiles (1 = exact)")
    ap.add_argument("--churn", action="store_true",
                    help="mid-stream session churn: one session leaves and "
                         "a new one joins halfway — its slot is rebuilt "
                         "from its own first frame (per-slot admission) "
                         "while the others stay incremental")
    ap.add_argument("--dry-run", action="store_true",
                    help="tiny shapes / few layers (the CI smoke path)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    engine, levels, d = build_engine(args)
    print(f"[stream] {engine.describe()}")
    if args.dry_run:
        cap = engine.capacity_estimate()
        print(f"[stream] capacity @ {cap['budget_bytes'] // 1024} KB budget "
              f"({cap['budget_source']}; {cap['rows_per_session']} "
              f"rows/session, active dtype {cap['table_dtype']}):")
        for dt_name, row in cap["per_dtype"].items():
            print(f"[stream]   {dt_name:8s} "
                  f"{row['bytes_per_session'] / 1024:7.1f} KB/session -> "
                  f"{row['sessions']} sessions")

    sids = [engine.open_session() for _ in range(args.sessions)]
    scenes = {sid: drifting_scene(100 + i, levels, d, args.frames,
                                  obj_rows=1, speed_rows=1)
              for i, sid in enumerate(sids)}
    # first frame of every session (a rebuild frame anyway), untimed
    for sid in sids:
        engine.submit_frame(sid, scenes[sid][0][0])
    engine.step()

    churn_at = args.frames // 2 \
        if args.churn and args.sessions > 1 and args.frames > 2 else None
    left = []
    t0 = time.perf_counter()
    for t in range(1, args.frames):
        if t == churn_at:
            old = sids.pop()
            left.append(engine.close_session(old))
            new = engine.open_session()
            sids.append(new)
            scenes[new] = drifting_scene(200 + new, levels, d, args.frames,
                                         obj_rows=1, speed_rows=1)
            print(f"[stream] churn: session {old} left after "
                  f"{left[-1].frames_done} frames, session {new} joined — "
                  "per-slot admission, neighbours stay incremental")
        for sid in sids:
            engine.submit_frame(sid, scenes[sid][t][0])
        engine.step()
        st = engine.mgr.last_stats
        print(f"frame {t}: {st['mode']:11s} "
              f"staged {st['staged_bytes']/1024:6.1f} KB "
              f"(rebuild would stage {st['rebuild_bytes']/1024:6.1f} KB), "
              f"dirty slots {st['n_dirty']}/{st['update_rows']}, "
              f"tiles {st['tiles_changed']}"
              + (f" [{st['reason']}]" if st["reason"] else "")
              + (f" [admitted slots {st['admitted_slots']}]"
                 if st.get("admitted_slots") else ""))
    dt = time.perf_counter() - t0

    r = engine.report()
    served = (args.frames - 1) * args.sessions
    print(f"\n[stream] {args.frames} frames x {args.sessions} sessions: "
          f"{served} timed frames in {dt:.2f}s = "
          f"{served/max(dt, 1e-9):.2f} frames/s ({engine.device.type})")
    print(f"[stream] staged bytes: rebuild-per-frame "
          f"{r['rebuild_bytes_total']/1024:.0f} KB vs incremental "
          f"{r['staged_bytes_total']/1024:.0f} KB = "
          f"{r['bytes_ratio']:.2f}x fewer "
          f"({r['incremental_frames']}/{r['frames']} frames incremental, "
          f"update cap {r['update_rows']}/{r['n_slots']} rows)")
    for sid in sids:
        sess = engine.close_session(sid)
        boxes = np.stack([f["boxes"] for f in sess.results])
        print(f"[stream] session {sid}: {len(sess.results)} frames, "
              f"mean box {np.mean(boxes, axis=(0, 1)).round(3)}")


if __name__ == "__main__":
    main()
