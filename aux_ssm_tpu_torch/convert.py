"""From the JAX package's parameters, given as NumPy arrays (for example
`np.asarray` of each field of an `aux_ssm_tpu.ops.LGSSM`), to the port's."""
import torch

from .ops.lgssm import LGSSM


def lgssm_from_numpy(m0, P0, Fs, Qs, bs, Hs, Rs, cs, ys, *, device, dtype):
    """Returns `(LGSSM, ys)` as tensors of `dtype` on `device`."""
    params = tuple(torch.as_tensor(z, dtype=dtype, device=device)
                   for z in (m0, P0, Fs, Qs, bs, Hs, Rs, cs))
    return LGSSM(*params), torch.as_tensor(ys, dtype=dtype, device=device)
