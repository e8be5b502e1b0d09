"""Optimizers of the PyTorch port."""

from .adadelta import Adadelta
from .adam import Adam
from .factory import create_optimizer
from .lamb import Lamb
from .lookahead import Lookahead
from .novograd import NovoGrad
from .nvnovograd import NvNovoGrad
from .rmsprop_tf import RMSpropTF
