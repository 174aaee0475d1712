from .factory import build_index_from_factory, parse_factory  # noqa: F401
from .flat import (  # noqa: F401
    FlatIndex,
    build_flat_index,
    load_flat_index,
    save_flat_index,
    search,
)
