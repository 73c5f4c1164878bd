"""Host-side constructions (counterpart of `aux_ssm_tpu/native/`)."""
