"""Models (counterpart of `aux_ssm_tpu/models/`)."""
