from .model import *  # noqa
from .source import *  # noqa
from .geometry import *  # noqa
from .acoustic import *  # noqa
from .utils import *  # noqa
from .tti import *  # noqa
