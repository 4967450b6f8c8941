"""Attention entry points, the CUDA kernels' wrappers and build, and the
DSP ops (mel filterbank, STFT, FISTA mel inversion, Griffin-Lim)."""
