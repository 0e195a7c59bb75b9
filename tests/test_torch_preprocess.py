"""The port's offline preprocessing and LMM harness against the JAX package,
on the CPU: `data/preprocess/{ner_typing, mongo_extract, clip_retrieval}`
and `lmm/prompting`.

* ner_typing and mongo_extract: outputs exactly equal to JAX's, over
  tests/test_preprocess.py's fake Mongo db, with each package's own
  HashWordTokenizer and HeuristicNER (and the byte-level BPE tokenizers of
  both packages on a fixture vocab);
* clip_retrieval: `rank_segments` gives JAX's indices on a text tower carried
  across by `weights_io.params_from_jax` (random embeddings: no exact ties),
  and `retrieve_sentences` JAX's string, repeated sentences included (tied
  segments are equal strings, so the order among them cannot show);
* `cli retrieve` writes JAX's CLI's output file, on one .npz written by JAX
  and one data dict;
* prompting: `build_prompts`, `prompt_captions` and `flatten_for_scoring` with
  `EchoBackend` give JAX's JSON.

Tolerance: exact (indices, strings, JSON, arrays bit for bit)."""

import dataclasses
import gzip
import json
import os
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.test_cli_end_to_end import _write_dataset
from tests.test_preprocess import FakeDB, _mk_article
from vacnic_tpu import cli as jcli
from vacnic_tpu.core.config import ClipVisionConfig as JClipCfg
from vacnic_tpu.data.clip_tokenize import ClipBpeTokenizer as JClipTok
from vacnic_tpu.data.preprocess import clip_retrieval as JR
from vacnic_tpu.data.preprocess import mongo_extract as JM
from vacnic_tpu.data.preprocess import ner_typing as JN
from vacnic_tpu.data.tokenize import BartBpeTokenizer as JBpe
from vacnic_tpu.data.tokenize import HashWordTokenizer as JHash
from vacnic_tpu.eval.entity_eval import HeuristicNER as JNER
from vacnic_tpu.lmm import prompting as JP
from vacnic_tpu.models import clip_vit as JV
from vacnic_tpu.models.clip_text import clip_text_init as j_clip_text_init
from vacnic_tpu_torch import cli
from vacnic_tpu_torch.data.clip_tokenize import ClipBpeTokenizer as TClipTok
from vacnic_tpu_torch.data.preprocess import clip_retrieval as TR
from vacnic_tpu_torch.data.preprocess import mongo_extract as TM
from vacnic_tpu_torch.data.preprocess import ner_typing as TN
from vacnic_tpu_torch.data.tokenize import BartBpeTokenizer as TBpe
from vacnic_tpu_torch.data.tokenize import HashWordTokenizer as THash
from vacnic_tpu_torch.eval.entity_eval import HeuristicNER as TNER
from vacnic_tpu_torch.lmm import prompting as TP
from vacnic_tpu_torch.models.weights_io import params_from_jax

REPO = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")
SPECIAL = ["<ENT>", "<NONAME>", "<PERSON>", "<ORGNORP>", "<GPELOC>"]

TEXTS = [
    "Obama met Apple in Paris yesterday with Obama",
    "Barack Obama visited the World Bank Group in New York",
    "Alice Smith of the United Nations Council spoke in London",
    "The crowd gathered as Bob Jones and Carol Diaz arrived at the Senate",
    "no entities at all here",
]


def _tokenizers(kind, tmp_path_factory):
    if kind == "hash":
        pair = JHash(50265), THash(50265)
    else:
        d = tmp_path_factory.mktemp("bpe")
        vocab = SMOKE["write_bpe_vocab"](str(d), words=SMOKE["FIXTURE_WORDS"] + (
            "Obama", "Barack", "Apple", "World", "Bank", "Group", "New", "York"), size=None)
        pair = JBpe(*vocab), TBpe(*vocab)
    for t in pair:
        t.add_special_tokens(SPECIAL)
    return pair


@pytest.fixture(scope="module", params=["hash", "bpe"])
def toks(request, tmp_path_factory):
    return _tokenizers(request.param, tmp_path_factory)


@pytest.mark.parametrize("ents,types", [
    (["Obama", "Apple", "Paris", "Obama", "France"], ["PERSON", "ORG", "GPE", "PERSON", "LOC"]),
    (["NATO", "Europe", "Smith", "Friday"], ["NORP", "LOC", "PERSON", "DATE"]),
    ([], []),
])
def test_make_ner_dict_by_type(ents, types):
    assert TN.make_ner_dict_by_type(ents, types) == JN.make_ner_dict_by_type(ents, types)


@pytest.mark.parametrize("text", TEXTS)
def test_process_article_and_caption_positions(text, toks):
    jt, tt = toks
    assert TN.process_article(text, TNER(lowercase=False), tt) == \
        JN.process_article(text, JNER(lowercase=False), jt)
    pid = tt.added_tokens["<PERSON>"]
    assert pid == jt.added_tokens["<PERSON>"]
    assert TN.caption_name_positions(text, TNER(lowercase=False), tt, person_token_id=pid) == \
        JN.caption_name_positions(text, JNER(lowercase=False), jt, person_token_id=pid)


def test_replace_entity_ids_and_name_pos_dict(toks):
    jt, tt = toks
    ents = ["Obama", "Apple", "Paris"]
    _, labels = JN.make_ner_dict_by_type(ents, ["PERSON", "ORG", "GPE"])
    assert TN.replace_entity_ids(TEXTS[0], ents, labels, tt) == \
        JN.replace_entity_ids(TEXTS[0], ents, labels, jt)
    dd = {f"h{i}": {"caption": t, "other": i} for i, t in enumerate(TEXTS)}
    pid = tt.added_tokens["<PERSON>"]
    assert TN.add_name_pos_to_dict(dd, TNER(lowercase=False), tt, pid) == \
        JN.add_name_pos_to_dict(dd, JNER(lowercase=False), jt, pid)


def test_mongo_sections():
    sections = _mk_article()["parsed_section"]
    for sec in sections:
        assert TM.get_ner_by_type(sec) == JM.get_ner_by_type(sec)
        assert TM.get_named_entities(sec) == JM.get_named_entities(sec)
    facenet = sections[2]["facenet_details"]
    for k in (1, 2, 3):
        (te, tp), (je, jp) = TM.top_k_faces(facenet, k), JM.top_k_faces(facenet, k)
        np.testing.assert_array_equal(te, je)
        assert tp == jp


@pytest.mark.parametrize("max_words", [4, 12, 510])
def test_build_context(max_words):
    tok = JHash(50265)
    art = _mk_article()
    for pos in (1, 2, 3):
        assert TM.build_context(art["parsed_section"], pos, art["headline"], tok, max_words) == \
            JM.build_context(art["parsed_section"], pos, art["headline"], tok, max_words)


def _same_records(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        assert set(a[k]) == set(b[k])
        for f, v in a[k].items():
            if isinstance(v, np.ndarray):
                assert v.dtype == b[k][f].dtype
                np.testing.assert_array_equal(v, b[k][f])
            else:
                assert v == b[k][f], f


@pytest.mark.parametrize("max_n_faces", [1, 2, 4])
def test_extract_article(max_n_faces):
    tok = JHash(50265)
    db = FakeDB([_mk_article()], [{"_id": "img1", "object_features": [[0.5] * 8]}])
    _same_records(TM.extract_article(db, "a1", tok, max_n_faces=max_n_faces),
                  JM.extract_article(db, "a1", tok, max_n_faces=max_n_faces))


def test_save_split(tmp_path):
    tok = JHash(50265)
    second = _mk_article()
    second["_id"], second["parsed_section"][2]["hash"] = "a2", "img2"
    db = FakeDB([_mk_article(), second], [{"_id": "img1", "object_features": [[0.5] * 8]}])
    outs = {}
    for name, mod in (("jax", JM), ("port", TM)):
        outs[name] = mod.save_split(db, "train", str(tmp_path / name), tok, max_n_faces=2)
    assert outs["port"] == outs["jax"]
    for rel in ("train_dict_newsmep_ent_seg.json", "articles_seg/img1.txt",
                "articles_seg/img2.txt"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for rel in ("faces/img1.npy", "objects/img1.npy"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / rel),
                                      np.load(tmp_path / "jax" / rel))
    assert sorted(os.listdir(tmp_path / "port" / "objects")) == ["img1.npy"]


# ---------------------------------------------------------------------------
# CLIP sentence retrieval
# ---------------------------------------------------------------------------

WORDS = ["the", "press", "photo", "shows", "alice", "smith", "waving", "in", "paris",
         "today", "crowd", "gathered", "council", "meeting", "river", "bridge"]


@pytest.fixture(scope="module")
def clip_text(tmp_path_factory):
    """A small text tower (JAX init, carried across) and each package's CLIP
    tokenizer on one fixture vocab."""
    d = tmp_path_factory.mktemp("clipvocab")
    path = SMOKE["write_clip_vocab"](str(d), WORDS)
    jt, tt = JClipTok.from_openai_vocab(path), TClipTok.from_openai_vocab(path)
    assert len(jt) == len(tt)
    jtower = jax.tree_util.tree_map(np.asarray, j_clip_text_init(
        jax.random.PRNGKey(4), vocab_size=len(jt) + 8, context_length=16, width=32, layers=2,
        heads=4, output_dim=16))
    return jtower, params_from_jax(jtower), jt, tt


def _segment_ids(n, seed, vocab, ctx=16):
    rng = np.random.RandomState(seed)
    ids = np.zeros((n, ctx), np.int32)
    for i in range(n):
        length = rng.randint(3, ctx)
        ids[i, :length - 1] = rng.randint(1, vocab - 1, length - 1)
        ids[i, length - 1] = vocab - 1  # the EOT token has the highest id
    return ids


@pytest.mark.parametrize("n_seg,k,seed", [(5, 3, 0), (12, 8, 1), (4, 8, 2), (20, 1, 3)])
def test_rank_segments_matches_jax(clip_text, n_seg, k, seed):
    jtower, ttower, _, _ = clip_text
    vocab = jtower["token_embedding"]["weight"].shape[0]
    ids = _segment_ids(n_seg, seed, vocab)
    img = np.random.RandomState(seed + 10).randn(16).astype(np.float32)
    want = np.asarray(JR.rank_segments(jtower, jax.numpy.asarray(img), jax.numpy.asarray(ids), k))
    got = TR.rank_segments(ttower, img, ids, k)
    assert got.dtype == torch.int64 and got.tolist() == want.tolist()
    assert len(want) == min(k, n_seg)


@pytest.mark.parametrize("article", [
    "Alice Smith waving in Paris today. The crowd gathered! Press photo shows the river? "
    "The council meeting in Paris. Smith shows the bridge today.",
    "The crowd gathered. The crowd gathered. Alice waving. The crowd gathered.",
    "single sentence without a break",
    "",
])
@pytest.mark.parametrize("num", [2, 8])
def test_retrieve_sentences_matches_jax(clip_text, article, num):
    jtower, ttower, jt, tt = clip_text
    assert TR.split_sentences(article) == JR.split_sentences(article)
    img = np.random.RandomState(len(article)).randn(16).astype(np.float32)
    want = JR.retrieve_sentences(jtower, jt, img, article, num_sentences=num)
    assert TR.retrieve_sentences(ttower, tt, img, article, num_sentences=num) == want
    assert TR.retrieve_sentences(ttower, tt, torch.from_numpy(img), article,
                                 num_sentences=num) == want


@pytest.fixture
def threefry():
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


def test_retrieve_matches_jax_cli(tmp_path, capsys, threefry):
    """A ViT-B/16-shaped vision tower (one layer, so the CLI's
    ClipVisionConfig() reads it) and a small text tower, written by JAX's
    save_tree; four rows: a multi-sentence "article", an article file, a
    single sentence, and a row without any article (skipped)."""
    data_dir = _write_dataset(tmp_path)
    test_dict = os.path.join(data_dir, "GoodNews",
                             "test_dict_newsmep_ent_clip8sent_contras_name_pos.json")
    base = os.path.join(data_dir, "GoodNews", "goodnews")
    clip_vocab = SMOKE["write_clip_vocab"](str(tmp_path), ["the", "press", "photo", "shows",
                                                           "alice", "smith", "paris", "crowd"])
    n_tok = len(TClipTok.from_dir(clip_vocab))
    vision = JV.clip_vision_init(jax.random.PRNGKey(2), dataclasses.replace(JClipCfg(), layers=1))
    text = j_clip_text_init(jax.random.PRNGKey(3), vocab_size=n_tok + 8, context_length=16,
                            width=32, layers=1, heads=4, output_dim=512)
    npz = str(tmp_path / "clip.npz")
    jcli._convert_checkpoint_module().save_tree({"vision": vision, "text": text}, npz)
    with open(test_dict) as f:
        dd = json.load(f)
    hs = list(dd)[:4]
    dd = {h: dict(dd[h]) for h in hs}
    dd[hs[0]]["article"] = ("The press photo shows Alice. Smith in Paris! The crowd? "
                            "Photo of the crowd. Alice shows Paris. The press.")
    dd[hs[2]]["article"] = "only one sentence here"
    os.makedirs(os.path.join(base, "articles_full"), exist_ok=True)
    with open(os.path.join(base, "articles_full", f"{hs[1]}.txt"), "w") as f:
        f.write("Alice Smith waving. The crowd gathered in Paris. Press photo today.")
    dd_path = tmp_path / "dd.json"
    dd_path.write_text(json.dumps(dd))
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        args = ["retrieve", "--data-dict", str(dd_path), "--data-base-dir", base,
                "--clip-ckpt", npz, "--clip-vocab", clip_vocab, "--num-sentences", "3",
                "--out", str(tmp_path / f"{name}.json")]
        assert main((["--device", "cpu"] if name == "port" else []) + args) == 0
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    out = json.loads((tmp_path / "port.json").read_text())
    assert out[hs[0]]["sents_byclip"] != dd[hs[0]]["sents_byclip"]
    assert len(TR.split_sentences(out[hs[0]]["sents_byclip"])) == 3
    assert out[hs[2]]["sents_byclip"] == "only one sentence here"
    assert out[hs[3]] == dd[hs[3]]  # no article: untouched
    assert "for 3 samples" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# LMM prompting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_retrieval", [True, False])
def test_prompting_with_echo_matches_jax(use_retrieval, tmp_path):
    arts = ["An article about Paris.", "Another one, longer, about the Senate meeting.", "x"]
    assert TP.build_prompts(arts, use_retrieval) == JP.build_prompts(arts, use_retrieval)
    batches = [{"article": arts[:2], "caption": ["c0", "c1"], "raw_img": [None, None]},
               {"article": arts[2:], "caption": ["c2"], "raw_img": [None]}]
    tout = TP.prompt_captions(TP.EchoBackend(), iter(batches), use_retrieval=use_retrieval,
                              out_path=str(tmp_path / "port.json"))
    jout = JP.prompt_captions(JP.EchoBackend(), iter(batches), use_retrieval=use_retrieval,
                              out_path=str(tmp_path / "jax.json"))
    assert tout == jout
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert TP.flatten_for_scoring(tout) == JP.flatten_for_scoring(jout)
    assert len(TP.flatten_for_scoring(tout)) == 3


def test_hf_backends_are_lazy():
    """The HF backends import transformers only when built; none is built
    here (their weights are not in the repo)."""
    assert TP.InstructBlipBackend.model_id == JP.InstructBlipBackend.model_id
    assert TP.LlavaBackend.model_id == JP.LlavaBackend.model_id
    assert TP.EchoBackend.name == "echo"


def test_clip_vocab_writer(tmp_path):
    """chip_smoke.write_clip_vocab: OpenAI's gz layout, one merge chain a
    word, so each fixture word is one token."""
    path = SMOKE["write_clip_vocab"](str(tmp_path), ["Press", "photo", "café"])
    with gzip.open(path, "rt", encoding="utf-8") as f:
        lines = f.read().splitlines()
    assert lines[1:] == ["p r", "pr e", "pre s", "pres s</w>", "p h", "ph o", "pho t",
                         "phot o</w>"]
    tok = TClipTok.from_openai_vocab(path)
    assert len(tok.encode("press photo", max_length=16)) == 4  # SOT, two words, EOT
    json.dumps(tok.encoder)  # a plain str -> int table
