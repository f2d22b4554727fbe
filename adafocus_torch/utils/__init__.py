"""Host-side utilities of the port: profiling and tracing hooks, the
torchvision weight converter, the device lock, patch visualization."""

from adafocus_torch.utils.profiling import trace  # noqa: F401
