"""Serving for the port: shape buckets, post-processing, DetrServeEngine,
and the LM token-decode engine (``serve.lm``)."""
from repro_torch.serve.buckets import BucketRouter, ShapeBucket, derive_buckets
from repro_torch.serve.engine import DetrRequest, DetrServeEngine
from repro_torch.serve.lm import Request, ServeConfig, ServeEngine
from repro_torch.serve.postproc import (PostprocWorker, StarvationError,
                                        softmax_np, topk_detections)

__all__ = ["BucketRouter", "DetrRequest", "DetrServeEngine", "PostprocWorker",
           "Request", "ServeConfig", "ServeEngine", "ShapeBucket",
           "StarvationError", "derive_buckets", "softmax_np",
           "topk_detections"]
