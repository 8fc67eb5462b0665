"""Host-side utilities of the PyTorch port: the config system, the logger
and metrics sink, and the windowed meters (copies of the JAX package's
``utils/`` modules of the same names, which the port may not import)."""
from .config import Config, load_config, merge_overrides, parse_config
from .logging import MetricsWriter, create_logger, get_logger
from .meters import AverageMeter
