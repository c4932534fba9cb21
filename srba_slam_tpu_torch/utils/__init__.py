"""Host-side utilities of the port."""

import numpy as np


def host_numpy(a) -> np.ndarray:
    """Host numpy of a tensor (on any device) or of an array."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
