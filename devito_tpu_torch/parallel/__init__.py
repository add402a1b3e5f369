from .distributor import *  # noqa
from .redistribute import redistribute  # noqa
