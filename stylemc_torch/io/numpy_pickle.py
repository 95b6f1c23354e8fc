"""A pickle reader that builds dicts, lists, tuples, Python scalars and
numpy arrays only, so a weights file or a training checkpoint runs no
code when it is read: the LPIPS weights (STYLEMC_LPIPS_<TYPE>) and the e4e
coach's checkpoints."""

from __future__ import annotations

import pickle


class NumpyUnpickler(pickle.Unpickler):
    """Refuses every class but numpy's arrays, dtypes and scalars and
    OrderedDict."""

    _ALLOWED = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"),
                ("numpy._core.multiarray", "scalar"),
                ("collections", "OrderedDict")}

    def find_class(self, module, name):
        if (module, name) in self._ALLOWED:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not allowed in a "
                                     "weights pickle")


def load_numpy_pickle(path: str):
    with open(path, "rb") as f:
        return NumpyUnpickler(f).load()
