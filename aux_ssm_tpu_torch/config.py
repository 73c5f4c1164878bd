"""Typed configuration (counterpart of `aux_ssm_tpu/config.py`): one
structured config for the experiment drivers.

ExperimentConfig = backend (dtype, device) + mesh + sampler style + MCMC
schedule (`experiments.runner.RunConfig`). `BackendConfig.apply()` applies
the global PyTorch settings; `from_args()` builds a config from dotted-path
overrides.
"""
import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch

from .device import default_device
from .experiments.runner import RunConfig

_DTYPES = {"single": torch.float32, "double": torch.float64}


@dataclass(frozen=True)
class BackendConfig:
    """Global settings (the JAX package's --precision, --platform, --debug,
    --debug-nans)."""
    precision: str = "single"          # 'single' | 'double'
    platform: Optional[str] = None     # None or 'gpu': the card; 'cpu'
    debug: bool = False                # the port runs eagerly: nothing to turn off
    # The runner's finite check after every step (`run_chain(...,
    # debug_nans=True)`, which the drivers pass from the same flag).
    debug_nans: bool = False

    @property
    def dtype(self):
        if self.precision not in _DTYPES:
            raise ValueError(f"precision must be one of {sorted(_DTYPES)}, got "
                             f"{self.precision!r}")
        return _DTYPES[self.precision]

    @property
    def device(self):
        """The card unless the platform is 'cpu', the only way to leave it."""
        if self.platform == "cpu":
            return torch.device("cpu")
        if self.platform not in (None, "gpu", "cuda"):
            raise ValueError(f"platform must be None, 'gpu' or 'cpu', got {self.platform!r}")
        return default_device()

    def apply(self):
        """Set the default dtype from `precision` and keep float32 matmuls
        and convolutions IEEE (no TF32: it collapses the MH acceptance).
        `debug_nans` sets nothing here: PyTorch has no counterpart of
        `jax_debug_nans`, and the runner checks the chain after each step
        instead (`experiments.runner.run_chain`'s `debug_nans`)."""
        torch.set_default_dtype(self.dtype)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout: axis names and sizes (-1 = inferred)."""
    axis_names: Tuple[str, ...] = ("chains",)
    axis_sizes: Optional[Tuple[int, ...]] = None

    def build(self, devices=None):
        """The mesh over `devices` (default every card; `parallel.mesh
        .make_mesh`)."""
        from .parallel.mesh import make_mesh
        return make_mesh(self.axis_sizes, devices, self.axis_names)


@dataclass(frozen=True)
class SamplerConfig:
    """Sampler selection (the reference's --style/--gradient/--backward/--N)."""
    style: str = "kalman-1"   # kalman-1 | kalman-2 | csmc | csmc-guided | pgas
    parallel: bool = True     # parallel-in-time execution
    gradient: bool = False
    backward: bool = True
    ancestor_sampling: bool = False
    n_particles: int = 25
    resampling: str = "multinomial"


@dataclass(frozen=True)
class ExperimentConfig:
    backend: BackendConfig = field(default_factory=BackendConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    sampler: SamplerConfig = field(default_factory=SamplerConfig)
    run: RunConfig = field(default_factory=RunConfig)
    seed: int = 42
    n_chains: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0          # 0 = only final


def _set(cfg, path, value):
    """Immutable nested update: _set(cfg, 'run.n_samples', 100)."""
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(cfg, **{head: _set(getattr(cfg, head), rest, value)})
    current = getattr(cfg, head)
    if current is not None and not isinstance(value, type(current)):
        value = type(current)(value)
    return dataclasses.replace(cfg, **{head: value})


def from_args(base: Optional[ExperimentConfig] = None, **overrides) -> ExperimentConfig:
    """Build a config from dotted-path overrides, e.g.
    from_args(**{"run.n_samples": 10_000, "sampler.style": "csmc"})."""
    cfg = base or ExperimentConfig()
    for path, value in overrides.items():
        cfg = _set(cfg, path, value)
    return cfg
