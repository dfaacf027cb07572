"""The reference's golden notebooks as scripts of the port, each runnable
as ``python -m nerf_fl_torch.notebooks.<name>``: the PSNR regression and
its four family wrappers, the static / transient decomposition of a view
and the appearance interpolation sweep.  They write PNGs (and a GIF) with
``data/image_io.py`` and run on the card unless asked for the CPU
(``NERF_FL_TORCH_DEVICE=cpu``)."""
