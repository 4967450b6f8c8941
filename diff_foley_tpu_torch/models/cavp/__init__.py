"""The CAVP towers (``diff_foley_tpu/models/cavp``): the shipped SlowOnly-R50
and CNN14, and the factory's X3D, I3D, R(2+1)D, ViViT, CNN10, spec
ResNet-50 and Spec-ViT."""
from .cavp import CAVPConfig, CAVPModel
from .cnn14 import Cnn14
from .slowonly import ResNet3dSlowOnly
