"""The CAVP towers (``diff_foley_tpu/models/cavp``): SlowOnly-R50 and CNN14."""
from .cavp import CAVPConfig, CAVPModel
from .cnn14 import Cnn14
from .slowonly import ResNet3dSlowOnly
