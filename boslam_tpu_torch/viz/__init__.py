"""Host-side map view (matplotlib, imported when it renders)."""

from boslam_tpu_torch.viz.viewer import render_map

__all__ = ["render_map"]
