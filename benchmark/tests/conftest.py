"""The small CPU sizes of the cells that ``_dry.py`` does not list, so that
the parametrised tests reach every cell of ``BENCHMARK.json``: the stereo
cell at ``euroc_mono.track``'s size and thresholds."""

from benchmark.tests import _dry

_dry.SMALL.setdefault("euroc_stereo.track", {
    "config": {"image_size": [128, 192], "buffer": 300, "fused_frame": True,
               "filter_thresh": 1.2},
    # at this size the poses' gaps read three to five times the cell's
    # (program 0.0013 against 0.00043, control 0.028 against 0.0058)
    "limits": {"update_pose_gap": 0.02}})
_dry.SECONDS.setdefault("euroc_stereo.track", 10.0)
