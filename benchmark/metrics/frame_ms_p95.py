"""The 95th percentile over every frame of the window, each timed from its
submission to its image on the host (host clock), in ms; linear between
the two nearest frames."""

import numpy as np


def read(record):
    if record["unit"] != "frame" or not record["window"]["latencies_s"]:
        return None
    return 1e3 * float(np.percentile(record["window"]["latencies_s"], 95))
