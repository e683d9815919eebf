"""Hand-written Hopper kernels of the port and their wrappers.

  * :mod:`repro_torch.kernels.msgs_fused` — K1, fused MSGS + aggregation
    (replaces ``msgs_fused_pallas`` / ``msgs_fused_packed_pallas``);
  * :mod:`repro_torch.kernels.msgs_decode` — K2, persistent-cache decode
    (replaces ``_decode_pallas_call``) and its backward (replaces the
    ``custom_vjp`` backward ``_msgs_decode_bwd``), the autograd op
    ``MsgsDecode``, plus ``stage_decode_table``;
  * :mod:`repro_torch.kernels.msgs_windowed` — K3, windowed
    multi-scale-parallel MSGS + aggregation (replaces
    ``msgs_windowed_msp_pallas``), plus ``window_geometry``;
  * :mod:`repro_torch.kernels.flash_decode` — K5, one-token GQA
    flash-decode attention (replaces ``flash_decode_pallas``);
  * :mod:`repro_torch.kernels.matmul` — K4, tiled matmul with the int8
    weight variant (replaces ``matmul_pallas``);
  * :mod:`repro_torch.kernels.ops` — all of them under the reference's
    public names (port of ``repro/kernels/ops.py``);
  * :mod:`repro_torch.kernels.build` — ``nvcc`` build and ``ctypes`` load.

Nothing is built or loaded at import time.
"""
