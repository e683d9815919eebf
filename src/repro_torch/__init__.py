"""repro_torch — the PyTorch / CUDA port of the DEFA system.

Each module sits at the same relative path as the module of the JAX
package it ports (``repro_torch/msda/cache.py`` ports
``repro/msda/cache.py``) and keeps that module's tensor layouts at its
public functions. The package imports ``torch`` and ``numpy`` only.

Layout of the first slice (one detection request, decoder head):

  * ``bridge`` — reference param pytree -> torch params, device checks;
  * ``core`` — nn primitives, fake-quant, PAP, FWP, the MSDeformAttn
    config/init/oracle, the encoder and the detector;
  * ``msda`` — plan, sampling geometry, value cache, backend registry
    (``torch_gather`` / ``cuda_fused`` / ``cuda_windowed`` /
    ``cuda_decode``), attention and the decoder;
  * ``kernels`` + ``csrc`` — the hand-written Hopper kernels (fused MSGS
    + aggregation, windowed multi-scale-parallel MSGS, persistent-cache
    decode), built with ``nvcc`` at first use and bound through
    ``ctypes``;
  * ``configs`` — the deformable-DETR family;
  * ``serve`` — shape buckets, post-processing and ``DetrServeEngine``.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on a machine without a CUDA device a default call
raises instead of running on the CPU.
"""
