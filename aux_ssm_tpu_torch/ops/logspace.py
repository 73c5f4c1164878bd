"""Log-space utilities (counterpart of `aux_ssm_tpu/ops/logspace.py`)."""
import math

import torch

_LOG_HALF = math.log(0.5)


def log1mexp(x):
    """Numerically stable log(1 - exp(x)) for x <= 0: log1p(-exp(x)) below
    log(1/2), log(-expm1(x)) above (Maechler 2012). Both branches run on
    safe inputs and are selected, so no branch yields a NaN gradient."""
    x = torch.as_tensor(x)
    small = x < _LOG_HALF
    safe_lo = torch.where(small, x, _LOG_HALF)
    safe_hi = torch.where(small, _LOG_HALF, x)
    return torch.where(small, torch.log1p(-torch.exp(safe_lo)),
                       torch.log(-torch.expm1(safe_hi)))


def logsubexp(x1, x2):
    """log|exp(x1) - exp(x2)| computed stably, elementwise."""
    x1, x2 = torch.as_tensor(x1), torch.as_tensor(x2)
    return torch.maximum(x1, x2) + log1mexp(-(x1 - x2).abs())


def normalize(log_weights, dim=None):
    """Softmax of log weights over `dim` (default: all elements)."""
    if dim is None:
        return torch.exp(log_weights - torch.logsumexp(log_weights.reshape(-1), 0))
    return torch.exp(log_weights - torch.logsumexp(log_weights, dim, keepdim=True))
