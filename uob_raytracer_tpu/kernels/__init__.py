from .render_fwd import render_fused, render_fused_res, pack_scene  # noqa: F401
