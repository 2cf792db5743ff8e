"""The port's ``tokenizer.json`` reader against the JAX package's
``HFTokenizer`` (``transformers.AutoTokenizer`` over ``tokenizers``).

Tokenizers are trained in-process with ``tokenizers`` and saved with
``transformers`` (no published tokenizer file: each would need a
download): a ``Whitespace`` BPE with an ``<unk>``, as
``tests/test_hf_convert.py`` writes one, and ``ByteLevel`` BPEs with and
without ``add_prefix_space``, under a ``Sequence`` and with the merges in the
older ``"a b"`` string form. Exact: the same ids from ``encode``, the same
text from ``decode``, and the same ``vocab_size``, ``BOS``, ``EOS``, ``PAD``.
"""

import json
import shutil

import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from kakveda_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer  # noqa: E402
from kakveda_tpu_torch.models.tokenizer import HFTokenizer  # noqa: E402

CORPUS = [
    "summarize the article with citations",
    "explain the theory with references",
    "the quick brown fox jumps over the lazy dog",
    "failure intelligence for language model applications",
    "it's 2024: don't panic, we're fine -- 3.14 * 2 = 6.28!",
] * 8

STRINGS = [
    "summarize the article with citations",
    "unseenword zyzzyva qwxj",  # words the merges never saw
    "Hello, world!!! ... ?! --> [ok] {x} (y)",  # punctuation runs
    "digits 12345 and 3.14159 x2 0x1F 1e-9",
    "naïve café — “quotes” 日本語 テスト Ελληνικά",  # non-ASCII
    "emoji 🚀🔥 ok 👍🏽 family 👨‍👩‍👧",
    "  leading and  double   spaces and trailing  ",
    " one leading space",
    "tab\tnew\nline\r\n end \n\n",
    "special <s> inside </s> text<unk> and <|endoftext|>x<pad>",  # specials inside the text
    "<s>",
    "it's don't we're I'm you'll he'd they've x''s ' t",
    "é combining and under_score snake_case",
    "²³ ⅻ ½",
    "",
    " ",
    "a",
]


def _train(pre_tokenizer, decoder, special, *, vocab=300, unk=None, alphabet=()):
    from tokenizers import Tokenizer, models, trainers

    tok = Tokenizer(models.BPE(unk_token=unk))
    tok.pre_tokenizer = pre_tokenizer
    if decoder is not None:
        tok.decoder = decoder
    tok.train_from_iterator(
        CORPUS, trainers.BpeTrainer(vocab_size=vocab, special_tokens=special, initial_alphabet=list(alphabet))
    )
    return tok


def _whitespace(path):
    from tokenizers import pre_tokenizers

    tok = _train(pre_tokenizers.Whitespace(), None, ["<unk>", "<s>", "</s>"], vocab=256, unk="<unk>")
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>", unk_token="<unk>"
    ).save_pretrained(str(path))


def _byte_level(path, prefix=True, sequence=False):
    from tokenizers import decoders, pre_tokenizers

    bl = pre_tokenizers.ByteLevel(add_prefix_space=prefix)
    pre = pre_tokenizers.Sequence([pre_tokenizers.Whitespace(), bl]) if sequence else bl
    tok = _train(pre, decoders.ByteLevel(), ["<|endoftext|>", "<pad>"], vocab=420,
                 alphabet=pre_tokenizers.ByteLevel.alphabet())
    kw = {} if sequence else {"add_prefix_space": prefix}
    transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<|endoftext|>", eos_token="<|endoftext|>", pad_token="<pad>", **kw
    ).save_pretrained(str(path))


def _string_merges(path):
    """The merges as ``"a b"`` strings, the form ``tokenizers`` wrote before
    0.20 (still read by it)."""
    f = path / "tokenizer.json"
    tj = json.loads(f.read_text())
    tj["model"]["merges"] = [" ".join(m) for m in tj["model"]["merges"]]
    f.write_text(json.dumps(tj))


def _no_config_prefix(path):
    """``tokenizer.json`` says add_prefix_space, the config says nothing:
    ``transformers`` loads it as False, so must the reader."""
    f = path / "tokenizer_config.json"
    cfg = json.loads(f.read_text())
    cfg.pop("add_prefix_space", None)
    f.write_text(json.dumps(cfg))


MAKERS = {
    "whitespace": _whitespace,
    "byte_level_prefix": lambda p: _byte_level(p, prefix=True),
    "byte_level": lambda p: _byte_level(p, prefix=False),
    "byte_level_string_merges": lambda p: (_byte_level(p, prefix=True), _string_merges(p)),
    "byte_level_prefix_not_in_config": lambda p: (_byte_level(p, prefix=True), _no_config_prefix(p)),
    "sequence": lambda p: _byte_level(p, prefix=True, sequence=True),
}


@pytest.fixture(scope="module")
def tok_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tokenizers")
    out = {}
    for name, make in MAKERS.items():
        out[name] = base / name
        out[name].mkdir()
        make(out[name])
    return out


@pytest.mark.parametrize("name", list(MAKERS))
def test_reader_matches_transformers_token_for_token(tok_dirs, name):
    ref = JaxHFTokenizer(str(tok_dirs[name]))
    port = HFTokenizer(str(tok_dirs[name]))
    assert (port.vocab_size, port.BOS, port.EOS, port.PAD) == (ref.vocab_size, ref.BOS, ref.EOS, ref.PAD)
    assert port.vocab_size == len(ref._tok)
    for s in STRINGS:
        for bos, eos in ((True, False), (False, True)):
            want = ref.encode(s, bos=bos, eos=eos)
            assert port.encode(s, bos=bos, eos=eos) == want, (s, bos, eos)
        ids = ref.encode(s)
        assert port.decode(ids) == ref.decode(ids), s
    every = list(range(port.vocab_size))  # every token, the specials skipped
    assert port.decode(every) == ref.decode(every)


def test_byte_level_round_trips_any_text(tok_dirs):
    """A byte-level vocabulary covers every byte: decode(encode(s)) == s."""
    port = HFTokenizer(str(tok_dirs["byte_level"]))
    for s in STRINGS:
        if "<" not in s:
            assert port.decode(port.encode(s)) == s


def _edit(src, dst, fn):
    shutil.copytree(src, dst)
    f = dst / "tokenizer.json"
    tj = json.loads(f.read_text())
    fn(tj)
    f.write_text(json.dumps(tj))
    return str(dst)


@pytest.mark.parametrize(
    "edit,names",
    [
        (lambda tj: tj.update(normalizer={"type": "Lowercase"}), "Lowercase"),
        (lambda tj: tj.update(normalizer={"type": "NFKC"}), "NFKC"),
        (lambda tj: tj.update(pre_tokenizer={"type": "Metaspace", "replacement": "▁"}), "Metaspace"),
        (lambda tj: tj.update(decoder={"type": "WordPiece", "prefix": "##"}), "WordPiece"),
        (lambda tj: tj["model"].update(type="Unigram"), "Unigram"),
        (lambda tj: tj["model"].update(byte_fallback=True), "byte_fallback"),
        (lambda tj: tj["model"].update(continuing_subword_prefix="##"), "continuing_subword_prefix"),
        (lambda tj: tj["model"].update(ignore_merges=True), "ignore_merges"),
        (lambda tj: tj["added_tokens"][0].update(lstrip=True), "lstrip"),
        (lambda tj: tj.update(pre_tokenizer={"type": "Sequence", "pretokenizers": [
            {"type": "Whitespace"}, {"type": "Digits", "individual_digits": True}]}), "Digits"),
    ],
)
def test_unsupported_components_raise_naming_them(tok_dirs, tmp_path, edit, names):
    path = _edit(tok_dirs["byte_level_prefix"], tmp_path / "t", edit)
    with pytest.raises(ValueError, match=names):
        HFTokenizer(path)


def test_normalizer_trained_with_tokenizers_raises(tmp_path):
    """A tokenizer trained with a normalizer (here ``tokenizers``' own
    Lowercase) is refused, not read without it."""
    from tokenizers import normalizers, pre_tokenizers

    tok = _train(pre_tokenizers.Whitespace(), None, ["<unk>"], unk="<unk>")
    tok.normalizer = normalizers.Lowercase()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>").save_pretrained(str(tmp_path))
    with pytest.raises(ValueError, match="normalizer 'Lowercase'"):
        HFTokenizer(str(tmp_path))


def test_a_directory_without_tokenizer_json_raises(tmp_path):
    with pytest.raises(ValueError, match="tokenizer.json"):
        HFTokenizer(str(tmp_path))
