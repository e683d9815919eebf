"""Core numerics of the port: nn primitives, fake-quant, PAP, FWP, the
MSDeformAttn config/init/oracle, the encoder and the detector."""
