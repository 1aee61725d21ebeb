"""Parity of the port's BERT text tower with the JAX package's.

Inputs come from numpy with a fixed seed; weights go JAX → weights.npz →
medmoe_torch.bridge. Tolerances as in tests/test_torch_models.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from medmoe_tpu.config import DotDict as JDotDict
from medmoe_tpu.models import text_encoder as jtext
from medmoe_torch.config import DotDict
from medmoe_torch.models import text_encoder as ttext
from tests.test_torch_models import (TEXT, assert_close, carry, text_inputs,
                                     torch_long)

torch.set_num_threads(1)


class TestText:
    def test_merge_wordpieces(self):
        rng = np.random.RandomState(4)
        stacked = rng.randn(2, 3, 6, 4).astype(np.float32)
        segs = np.array([[0, 1, 1, 2, -1, -1], [0, 1, 2, 3, 4, -1]], np.int32)
        want = jtext.merge_wordpieces(jnp.asarray(stacked), jnp.asarray(segs))
        got = ttext.merge_wordpieces(torch.from_numpy(stacked),
                                     torch.from_numpy(segs).long())
        assert_close(got, want, "float32")

    @pytest.mark.parametrize("dt,norm", [("float32", False),
                                         ("float32", True),
                                         ("bfloat16", False)])
    def test_text_encoder(self, dt, norm, tmp_path):
        cfg = dict(TEXT, dtype=dt, norm=norm)
        je = jtext.BertTextEncoder(JDotDict(cfg))
        args = text_inputs()
        p = jax.jit(je.init)(jax.random.PRNGKey(1),
                             *map(jnp.asarray, args))["params"]
        te = carry(p, tmp_path, ttext.BertTextEncoder(DotDict(cfg)))
        jw, js = je.apply({"params": p}, *map(jnp.asarray, args))
        with torch.no_grad():
            tw, ts = te(*torch_long(*args))
        assert tuple(tw.shape) == (4, 32, 10)
        assert_close(tw.float(), jw, dt)
        assert_close(ts.float(), js, dt)
