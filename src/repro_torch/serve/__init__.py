"""Serving for the port: shape buckets, post-processing, DetrServeEngine,
StreamingDetrEngine (video sessions over persistent value caches) and
the LM token-decode engine (``serve.lm``)."""
from repro_torch.serve.buckets import BucketRouter, ShapeBucket, derive_buckets
from repro_torch.serve.engine import (DetrRequest, DetrServeEngine,
                                      StreamingDetrEngine, StreamSession)
from repro_torch.serve.lm import Request, ServeConfig, ServeEngine
from repro_torch.serve.postproc import (PostprocWorker, StarvationError,
                                        softmax_np, topk_detections)

__all__ = ["BucketRouter", "DetrRequest", "DetrServeEngine", "PostprocWorker",
           "Request", "ServeConfig", "ServeEngine", "ShapeBucket",
           "StarvationError", "StreamSession", "StreamingDetrEngine",
           "derive_buckets", "softmax_np", "topk_detections"]
