"""``JaxKey``: a ``jax.random`` key behind the port's key interface.

``solr_tpu_torch`` takes its random draws from a key with four methods
(``split``, ``fold_in``, ``uniform``, ``normal``;
solr_tpu_torch/ops/rng.py).  A JaxKey answers them with
``jax.random.split``, ``fold_in``, ``uniform`` and ``normal`` on the
wrapped key and returns torch tensors on the CPU, so the port, handed a JaxKey, makes exactly the draws that ``solr_tpu``
makes from the same key, and a stochastic frame can be held to the
reference pixel by pixel.  The port itself never sees JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

_DTYPES = {torch.float32: jnp.float32, torch.float64: jnp.float64}


class JaxKey:
    def __init__(self, key):
        if isinstance(key, int):
            key = jax.random.PRNGKey(key)
        self.key = key
        self.device = torch.device("cpu")

    def split(self, n: int = 2) -> list:
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, i: int) -> "JaxKey":
        return JaxKey(jax.random.fold_in(self.key, i))

    def uniform(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(jax.random.uniform(
            self.key, tuple(shape), _DTYPES[dtype])))

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.array(jax.random.normal(
            self.key, tuple(shape), _DTYPES[dtype])))
