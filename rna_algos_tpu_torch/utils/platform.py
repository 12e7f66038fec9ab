"""Device detection for the kernel dispatchers
(``rna_algos_tpu.utils.platform``).

The JAX package asks whether a default-placed computation would land on a
TPU (``on_tpu``).  The port places nothing by default: every tensor names
its device, and a wrapper launches its kernel for a CUDA tensor and runs the
plain version for a CPU tensor.  So the question here is about one tensor,
device or device string: ``on_cuda``.
"""

import torch


def on_cuda(x):
    """True iff ``x`` (a tensor, a ``torch.device`` or a device string)
    is on a CUDA device.  Only looks at the device's type: it neither asks
    for a GPU nor initialises CUDA."""
    device = x.device if torch.is_tensor(x) else torch.device(x)
    return device.type == "cuda"


def resolve_device(device):
    """torch.device for ``device``; a CUDA device with no GPU raises (the
    port never falls back to the CPU)."""
    device = torch.device(device)
    if on_cuda(device) and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but no CUDA GPU is available"
        )
    return device
