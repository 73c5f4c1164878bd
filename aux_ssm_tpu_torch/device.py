"""Where the port's entry points allocate when the caller names no device."""
import torch


def default_device():
    """The card. Availability is not probed: on a machine without one the
    first allocation fails, and nothing carries on on the CPU unasked."""
    return torch.device("cuda")


def resolve(device):
    """`device`, or the default device for None."""
    return default_device() if device is None else torch.device(device)
