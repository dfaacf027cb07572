from . import metrics  # noqa: F401
from .system import (  # noqa: F401
    build_params, render_chunked, render_chunked_async, val_chunk_cap,
)
