"""Device-side numeric ops: FFT autocovariance and the GPU GLM trajectory
kernel."""
from .acf import autocov

__all__ = ["autocov"]
