from . import losses, metrics, optimizers  # noqa: F401
from .system import (  # noqa: F401
    build_params, epoch_perm, make_device_pool_step, make_train_step,
    render_chunked, render_chunked_async, stack_batches, val_chunk_cap,
)
