"""Samplers (counterpart of `aux_ssm_tpu/kernels/`)."""
