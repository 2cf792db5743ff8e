"""The port's featurizer against the JAX package's, on the same texts.

Tolerance: atol 1e-6 on L2-normalized f32 rows (both sides sum the same
terms in the same order; the JAX package may take its C++ encoder, which
emits the same features and buckets)."""

import numpy as np
import pytest
import torch

from kakveda_tpu.core.fingerprint import signature_text
from kakveda_tpu.ops.featurizer import HashedNGramFeaturizer as JaxFeaturizer
from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
from kakveda_tpu_torch.ops.knn import Knn

TEXTS = {
    "signature": [
        signature_text("Summarize this document and include citations even if not provided.", [], {"os": "linux"}),
        signature_text("Explain research paper and add references.", ["search", "calc"], {"os": "linux", "region": "eu"}),
        signature_text("What's 2+2?", [], {}),
    ],
    "free": ["the quick brown fox jumps over the lazy dog", "timeout calling tool search_v2 after 30s"],
    "empty": ["", "   ", " | "],
    "non_ascii": ["Résumé des références — naïve café", "日本語の要約 citations 引用", "Ünïcödé | intent_tags:x,Ÿ"],
}


@pytest.mark.parametrize("case", sorted(TEXTS))
@pytest.mark.parametrize("dim", [1024, 2048])
def test_encode_batch_matches_jax(case, dim):
    texts = TEXTS[case]
    ref = JaxFeaturizer(dim=dim).encode_batch(texts)
    out = HashedNGramFeaturizer(dim=dim).encode_batch(texts)
    assert out.shape == ref.shape == (len(texts), dim) and out.dtype == np.float32
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case", sorted(TEXTS))
def test_encode_batch_sparse_densifies_to_jax(case):
    texts = TEXTS[case]
    dim = 2048
    ref = JaxFeaturizer(dim=dim).encode_batch(texts)
    idx, val = HashedNGramFeaturizer(dim=dim).encode_batch_sparse(texts)
    assert idx.dtype == np.int32 and val.dtype == np.float32
    k = idx.shape[1]
    assert k >= 64 and k & (k - 1) == 0
    assert np.all(val[idx == dim] == 0), "pad features carry the drop sentinel"
    dense = Knn(4, dim, device="cpu").densify(torch.from_numpy(idx), torch.from_numpy(val))
    np.testing.assert_allclose(dense.numpy(), ref, atol=1e-6, rtol=0)


def test_dim_must_be_power_of_two():
    with pytest.raises(ValueError):
        HashedNGramFeaturizer(dim=1000)
