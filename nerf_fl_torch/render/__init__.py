from .renderer import RenderConfig, render_rays  # noqa: F401
