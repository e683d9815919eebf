"""End-to-end driver of the PyTorch port: train the toy deformable
detector on synthetic rectangle detection, then compare the AP of the
exact model with the DEFA-pruned model's (port of examples/detr_train.py).

  PYTHONPATH=src python examples/torch_detr_train.py --steps 80 [--device cpu]
  PYTHONPATH=src python examples/torch_detr_train.py --decoder   # the
      decoder-head toy (3 layers x 24 queries, 400 steps, K2 in training)

The trained toy is cached as a checkpoint store under results/.
"""
import argparse

from repro_torch.train.detr import (
    eval_ap, train_toy_decoder_detector, train_toy_detector, with_attn)

DEFA_THRESHOLD_KW = dict(pap_mode="threshold", pap_threshold=0.02,
                         fwp_mode="compact", fwp_k=1.0, fwp_capacity=0.6,
                         range_narrow=(8.0, 6.0, 4.0, 3.0),
                         act_bits=12, weight_bits=12)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="training steps (default 80; 400 with --decoder)")
    ap.add_argument("--decoder", action="store_true",
                    help="the decoder-head toy detector")
    ap.add_argument("--force", action="store_true", help="retrain")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    train = train_toy_decoder_detector if args.decoder else train_toy_detector
    kw = {} if args.steps is None else {"steps": args.steps}
    cfg, params = train(force=args.force, device=args.device, **kw)
    ap_base = eval_ap(cfg, params)
    print(f"\nAP (exact MSDeformAttn):      {ap_base:.4f}")

    defa = with_attn(cfg, **DEFA_THRESHOLD_KW)
    ap_defa = eval_ap(defa, params)
    print(f"AP (DEFA: FWP+PAP+RN+INT12):  {ap_defa:.4f}  "
          f"(delta {ap_defa - ap_base:+.4f}; paper's COCO deltas sum to ~-1.4 "
          f"AP before finetuning recovery)")


if __name__ == "__main__":
    main()
