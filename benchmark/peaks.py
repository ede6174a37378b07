"""The table of published peaks (``peaks.json``), by the device's name."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "peaks.json")) as _f:
    TABLE = json.load(_f)


def get(kind, key):
    """The peak ``key`` of the device named ``kind``, or None."""
    return TABLE.get(kind, {}).get(key)
