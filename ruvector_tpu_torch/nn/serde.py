"""Parameter tree <-> JSON, in the same format as the JAX package's serde.

Arrays become `{"__array__": nested lists, "dtype": name}`; structure keys
are preserved, so a tree written by either package reads back in the
other.
"""

from __future__ import annotations

import json
from typing import Any

import numpy as np

from ruvector_tpu_torch.convert import params_from_numpy, params_to_numpy


def params_to_json(params: Any) -> str:
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        arr = np.asarray(node)
        return {"__array__": arr.tolist(), "dtype": str(arr.dtype)}

    return json.dumps(conv(params_to_numpy(params)))


def params_from_json(text: str, device=None) -> Any:
    def conv(node):
        if isinstance(node, dict):
            if "__array__" in node:
                return np.asarray(node["__array__"], dtype=node["dtype"])
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return [conv(v) for v in node]
        return node

    return params_from_numpy(conv(json.loads(text)), device)
