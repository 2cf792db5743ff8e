"""The port's C++ host tier against the JAX package's, on the CPU.

The port compiles its own copy of the reference's encoder with the same
flags, so its embeddings must equal the JAX package's native embeddings
bit for bit (``np.array_equal``, dense and sparse, the same K). Against
the port's own Python path the tolerance is 2 float32 ulps of each value
(1.2e-7 at |x| < 1), with the same buckets: the C++ norm sums in double
and scales by a rounded reciprocal, Python sums in float32 and divides,
so a normalized value may differ in its last two bits, in the reference
as well (its own test allows 2e-7).
"""

import zlib

import numpy as np
import pytest

from kakveda_tpu import native as jax_native
from kakveda_tpu.core.fingerprint import signature_text
from kakveda_tpu.index.gfkb import GFKB as JaxGFKB
from kakveda_tpu.ops.featurizer import HashedNGramFeaturizer as JaxFeaturizer
from kakveda_tpu_torch import native
from kakveda_tpu_torch.index.gfkb import GFKB
from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer, dense_rows_to_sparse

WORDS = (
    "summarize document citations references explain paper timeout tool search "
    "calc report quarterly answer short include provided even if not with and "
    "the a of 42 v2 error_code http_500 retry json parse schema"
).split()
ALPHABET = np.array(list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789 _:,|.!?-=\t"))


def _signatures(n: int, seed: int):
    """Half structured (``signature_text`` of random prompts, tools and
    env), half free-form ASCII (field separators, colons and commas in
    random places, so every branch of ``encode_one`` is taken)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 2 == 0:
            prompt = " ".join(rng.choice(WORDS, size=rng.integers(0, 30)))
            if rng.random() < 0.5:
                prompt = prompt.upper() if rng.random() < 0.3 else prompt.capitalize()
            tools = list(rng.choice(WORDS, size=rng.integers(0, 4)))
            env = {str(k): int(rng.integers(0, 9)) for k in rng.choice(WORDS, size=rng.integers(0, 4))}
            out.append(signature_text(prompt, tools, env))
        else:
            out.append("".join(rng.choice(ALPHABET, size=rng.integers(0, 400))))
    out += ["", " | ", "intent_tags: a, b , c | prompt_hint: Hello World_9 | tools:  | env_keys: os",
            "UNKNOWN_Field: Stuff Here | intent_tags: x", "trailing field sep | "]
    return out


@pytest.fixture(scope="module")
def libs():
    port, ref = native.load(), jax_native.load()
    assert port is not None, native.status()
    assert ref is not None, "the JAX package's native library must build for the parity test"
    return port, ref


def test_crc32_matches_zlib(libs):
    lib = libs[0]
    rng = np.random.default_rng(0)
    cases = [b"", b"a", b"hello world", bytes(range(256))]
    cases += [bytes(rng.integers(0, 256, size=rng.integers(1, 300), dtype=np.uint8)) for _ in range(100)]
    for c in cases:
        assert lib.kkv_crc32(c, len(c)) == zlib.crc32(c)


@pytest.mark.parametrize("dim", [1024, 2048])
def test_dense_encoder_bit_identical_to_jax_native(libs, dim):
    texts = _signatures(2048, seed=dim)
    port = HashedNGramFeaturizer(dim=dim)._encode_batch_native(libs[0], texts)
    ref = JaxFeaturizer(dim=dim)._encode_batch_native(libs[1], texts)
    assert port.dtype == ref.dtype == np.float32 and port.shape == (len(texts), dim)
    assert np.array_equal(port, ref)
    # And the public entry point takes the library on an ASCII batch.
    assert np.array_equal(HashedNGramFeaturizer(dim=dim).encode_batch(texts), ref)


@pytest.mark.parametrize("dim", [1024, 2048])
def test_sparse_encoder_bit_identical_to_jax_native(libs, dim):
    texts = _signatures(2048, seed=dim + 1)
    idx, val = HashedNGramFeaturizer(dim=dim).encode_batch_sparse(texts)
    ridx, rval = JaxFeaturizer(dim=dim).encode_batch_sparse(texts)
    assert idx.shape == ridx.shape and idx.shape[1] >= 64
    assert np.array_equal(idx, ridx) and np.array_equal(val, rval)


def test_sparse_width_grows_past_64(libs):
    # A row with more than 64 nonzeros: the K loop doubles to what the
    # library asks for, as the reference does.
    text = " ".join(f"w{i}" for i in range(80))
    idx, val = HashedNGramFeaturizer(dim=2048).encode_batch_sparse([text, "short"])
    ridx, rval = JaxFeaturizer(dim=2048).encode_batch_sparse([text, "short"])
    assert idx.shape[1] == 256 and np.array_equal(idx, ridx) and np.array_equal(val, rval)


@pytest.mark.parametrize("dim", [1024, 2048])
def test_native_within_2_ulp_of_python_path(libs, dim):
    texts = _signatures(2048, seed=dim + 2)
    f = HashedNGramFeaturizer(dim=dim)
    nat = f._encode_batch_native(libs[0], texts)
    py = f._encode_batch_py(texts)
    assert ((nat != 0) == (py != 0)).all(), "bucket support must match exactly"
    np.testing.assert_array_max_ulp(nat, py, maxulp=2)
    sp_i, sp_v = f._encode_sparse_native(libs[0], texts)
    py_i, py_v = dense_rows_to_sparse(py, dim)
    assert np.array_equal(sp_i, py_i)
    np.testing.assert_array_max_ulp(sp_v, py_v, maxulp=2)


def test_non_ascii_batch_takes_python_path(libs, monkeypatch):
    f = HashedNGramFeaturizer(dim=256)
    texts = ["prompt_hint: café résumé", "plain ascii"]
    monkeypatch.setattr(f, "_encode_batch_native", lambda *a: pytest.fail("native on non-ASCII"))
    monkeypatch.setattr(f, "_encode_sparse_native", lambda *a: pytest.fail("native on non-ASCII"))
    assert np.array_equal(f.encode_batch(texts), f._encode_batch_py(texts))
    idx, val = f.encode_batch_sparse(texts)
    assert np.array_equal(idx, dense_rows_to_sparse(f._encode_batch_py(texts), 256)[0])


def test_env_zero_forces_python_path(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setenv("KAKVEDA_NATIVE", "0")
    assert native.load() is None and native.status()["available"] is False
    f = HashedNGramFeaturizer(dim=256)
    texts = ["still works via python", "intent_tags: a, b"]
    assert np.array_equal(f.encode_batch(texts), f._encode_batch_py(texts))


def test_require_raises_when_the_library_cannot_build(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_attempted", False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setenv("KAKVEDA_NATIVE", "require")
    with pytest.raises(RuntimeError, match="require"):
        native.load()
    assert native.status() == {"available": False, "mode": "require", "lib": None}


def test_library_is_named_by_source_and_flags(monkeypatch):
    path = native.lib_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libkakveda_native-")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g",))
    assert native.lib_path() != path
    assert "-march=native" not in native.CXX_FLAGS and "-ffast-math" not in native.CXX_FLAGS


@pytest.mark.parametrize("use_native", [True, False])
def test_append_log_roundtrip(tmp_path, monkeypatch, use_native):
    if not use_native:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_load_attempted", False)
        monkeypatch.setenv("KAKVEDA_NATIVE", "0")
    p = tmp_path / "log.jsonl"
    with native.AppendLog(p, flush_bytes=256) as log:
        assert log.native is use_native
        for i in range(100):
            log.append(f'{{"i": {i}}}\n'.encode())
        log.flush(fsync=True)
        lines = p.read_text().splitlines()
        assert len(lines) == 100 and lines[42] == '{"i": 42}'
    # Append mode: reopening continues the log; close flushes.
    with native.AppendLog(p) as log:
        log.append(b'{"i": 100}\n')
    assert len(p.read_text().splitlines()) == 101


def _fill(store, upsert_pattern):
    sigs = [
        signature_text("Summarize this document and include citations even if not provided.", [], {"os": "linux"}),
        signature_text("Explain research paper and add references.", ["search"], {"os": "linux"}),
        signature_text("Short answer with citations", [], {}),
    ]
    for i, (sig, app) in enumerate(zip(sigs + sigs[:1], ["app-A", "app-B", "app-A", "app-C"])):
        store.upsert_failure(
            failure_type="HALLUCINATION_CITATION" if i != 1 else "TIMEOUT",
            signature_text=sig, app_id=app, impact_severity="medium", resolution=f"fix {i}",
        )
    upsert_pattern(name="Citation hallucination without sources", failure_ids=["F-0001", "F-0003"],
                   affected_apps=["app-A", "app-C"], description="d")
    upsert_pattern(name="Citation hallucination without sources", failure_ids=["F-0002"],
                   affected_apps=["app-B"])
    return sigs


def _view(store):
    fails = [(f.failure_id, f.version, f.failure_type, f.signature_text, tuple(f.affected_apps), f.occurrences)
             for f in store.list_failures()]
    pats = [(p.pattern_id, p.name, tuple(p.failure_ids), tuple(p.affected_apps), p.description)
            for p in store.list_patterns()]
    return fails, pats


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_data_dir_cross_loads_both_ways(libs, tmp_path, writer):
    """A data dir written through one package's native log opens in the
    other: same records, versions, patterns, and the same top-1 match."""
    if writer == "port":
        w = GFKB(data_dir=tmp_path, capacity=64, dim=1024, device="cpu")
    else:
        w = JaxGFKB(data_dir=tmp_path, capacity=64, dim=1024)
    sigs = _fill(w, w.upsert_pattern)
    if writer == "port":
        assert w._logs and all(alog.native for alog in w._logs.values())
    want = _view(w)
    w.close()
    r = JaxGFKB(data_dir=tmp_path, capacity=64, dim=1024) if writer == "port" else GFKB(
        data_dir=tmp_path, capacity=64, dim=1024, device="cpu")
    assert _view(r) == want
    assert [m.failure_id for m in r.match(sigs[1])][:1] == ["F-0002"]
    r.close()
