"""Step-size (delta) adaptation (counterpart of `aux_ssm_tpu/kernels/adaptation.py`)."""
import torch


def delta_adaptation(delta, target_rate, acceptance_rate, adaptation_rate,
                     min_delta=1e-20, max_delta=1e20):
    """Multiplicative delta update: delta * exp(rate * (acc - target)),
    clipped to [min_delta, max_delta]. Elementwise on tensors."""
    delta = torch.as_tensor(delta)
    acc = torch.as_tensor(acceptance_rate, dtype=delta.dtype, device=delta.device)
    return torch.clamp(delta * torch.exp(adaptation_rate * (acc - target_rate)),
                       min_delta, max_delta)
