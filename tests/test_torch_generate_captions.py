"""The slice as a whole on the CPU: dataset on disk -> tokenize -> collate ->
PrefetchLoader -> `fit` -> `generate_captions` -> metrics JSON, on
VacnicConfig.tiny() with its vocab widened to a real byte-level BPE vocab,
over an on-disk GoodNews-layout fixture (chip_smoke.py's writers, the data
phase's, at 32 px and 8-wide faces):

* port `generate_captions(device="cpu")` against JAX's on the same weights
  (carried across by `weights_io.params_from_jax`) and the same rows: JAX's
  loaders from its own CLI wiring (`vacnic_tpu.cli._make_loaders`), JAX's
  decode with the Pallas decode and encoder kernels selected (interpret
  mode on the CPU), as tests/test_torch_generate.py does, the image
  features from each package's CLIP tower on the rows' pixels. The beam
  tokens are identical, and so are the `{step: {gt, gen}}` strings, the
  metrics and the JSON file, and the same over a 2-way CPU mesh from a
  `PrefetchLoader(sharding=)`; the default device without a card raises;
* port `fit` over PrefetchLoader(device="cpu") batches with the teacher
  cache for 2 epochs: epoch 2 runs no teacher forward, every metric is
  finite, best/ last/ and val_outputs.json are written, and `sample_idx`
  is read back with one host copy (a tensor numpy cannot read, as a CUDA
  tensor, is accepted).

Tolerance: tokens, strings and metrics exact."""

import dataclasses
import json
import math
import os
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from vacnic_tpu.cli import _make_loaders
from vacnic_tpu.core.config import VacnicConfig as JCfg
from vacnic_tpu.data.tokenize import BartBpeTokenizer as JBpe
from vacnic_tpu.models import clip_vit as JV
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train import loop as JL
from vacnic_tpu_torch.core.config import MeshConfig, VacnicConfig as TCfg
from vacnic_tpu_torch.core.mesh import make_mesh
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.data.datasets import ascii_fold
from vacnic_tpu_torch.data.pipeline import shard_for_data_parallel
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.clip_vit import clip_vision_init
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import loop as TL
from vacnic_tpu_torch.train.train_step import make_train_step

REPO = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")
SPLITS = (("train", 4), ("val", 2), ("test", 4))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("news")
    vocab = SMOKE["write_bpe_vocab"](str(root), size=None)
    base, dicts = SMOKE["write_news_fixture"](str(root), splits=SPLITS, image_size=32,
                                              face_dim=8, article_words=40, caption_words=6)
    n_vocab = len(json.load(open(vocab[0]))) + 8  # room for the five added tokens
    cfgs = []
    for C in (JCfg, TCfg):
        c = C.tiny()
        cfgs.append(dataclasses.replace(
            c, bart=dataclasses.replace(c.bart, vocab_size=n_vocab),
            fusion=dataclasses.replace(c.fusion, ner_vocab_size=n_vocab),
            data=dataclasses.replace(c.data, data_dir=str(root), num_workers=2),
            train=dataclasses.replace(c.train, val_batch_size=2, num_epochs=2,
                                      teacher_cache=True),
            decode=dataclasses.replace(c.decode, num_beams=3, max_length=8)))
    return root, base, dicts, vocab, cfgs


@pytest.fixture
def threefry():
    """JAX's default PRNG for the weights' init, whatever an earlier test in
    this process left selected (the JAX CLI selects "rbg")."""
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


def test_generate_captions_matches_jax(data, tmp_path, monkeypatch, threefry):
    root, base, dicts, vocab, (jcfg, tcfg) = data
    rng = np.random.RandomState(1)
    # a wider weight spread than the init's 0.02, so the beams choose varied tokens
    jmodel = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32),
        JF.multimodal_bart_init(jax.random.PRNGKey(0), jcfg.bart, jcfg.fusion))
    jclip = jax.tree_util.tree_map(np.asarray, JV.clip_vision_init(jax.random.PRNGKey(1),
                                                                   jcfg.clip))
    jtok = JBpe(*vocab)
    jtok.add_special_tokens(list(SMOKE["SPECIAL_TOKENS"]))
    ttok = SMOKE["news_tokenizer"](*vocab)
    (jloader,) = _make_loaders(jcfg, jtok, [(str(root / "GoodNews" / "test_dict.json"), False)])
    tloader = SMOKE["news_loader"](tcfg, ttok, base, dicts["test"], False, "cpu")
    assert len(tloader) == len(jloader) == 2

    tokens = {"jax": [], "port": []}

    def recorder(fn, key):
        def call(*a, **kw):
            seqs, scores = fn(*a, **kw)
            tokens[key].append(np.asarray(seqs))
            return seqs, scores
        return call

    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")
    monkeypatch.setattr(JL, "generate_mm", recorder(JL.generate_mm, "jax"))
    monkeypatch.setattr(TL, "generate_mm", recorder(TL.generate_mm, "port"))
    jout = JL.generate_captions(jcfg, {"model": jmodel, "clip": jclip}, jloader, jtok,
                                out_path=str(tmp_path / "jax.json"))
    tparams = {"model": params_from_jax(jmodel), "clip": params_from_jax(jclip)}
    tout = TL.generate_captions(tcfg, tparams, tloader, ttok, out_path=str(tmp_path / "port.json"),
                                device="cpu")
    for a, b in zip(tokens["port"], tokens["jax"]):
        np.testing.assert_array_equal(a, b)
    seqs = np.concatenate(tokens["port"])
    assert seqs.shape == (4, tcfg.decode.max_length) and len(np.unique(seqs)) > 6
    assert tout == jout
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    rows = [k for k in tout if k not in ("bleu", "other metrics")]
    assert rows == [0, 1, 2, 3] and set(tout[0]) == {"gt", "gen"}
    assert tout[0]["gen"] == ascii_fold(ttok.decode(seqs[0], skip_special_tokens=True))
    om = tout["other metrics"]
    assert om["meteor_scorer"] == "meteor15_py(exact+stem)" and math.isfinite(om["cider"])

    # over a 2-way CPU mesh, from a loader that puts each batch's row shards
    # on their devices: the same captions, metrics and file
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 2)
    sloader = SMOKE["news_loader"](tcfg, ttok, base, dicts["test"], False,
                                   sharding=shard_for_data_parallel(mesh))
    mout = TL.generate_captions(tcfg, tparams, sloader, ttok, mesh=mesh,
                                out_path=str(tmp_path / "mesh.json"))
    assert mout == tout
    assert (tmp_path / "mesh.json").read_text() == (tmp_path / "port.json").read_text()
    with pytest.raises(ValueError, match="a mesh or a device, not both"):
        TL.generate_captions(tcfg, tparams, [], ttok, mesh=mesh, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.generate_captions(tcfg, tparams, [], ttok)


class NoNumpy(torch.Tensor):
    """A tensor numpy cannot read, as numpy cannot read a CUDA tensor."""

    def __array__(self, *a, **kw):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


def test_fit_over_the_loader_with_the_teacher_cache(data, tmp_path, monkeypatch):
    root, base, dicts, vocab, (_, cfg) = data
    tok = SMOKE["news_tokenizer"](*vocab)
    train = SMOKE["news_loader"](cfg, tok, base, dicts["train"], True, "cpu")
    val = SMOKE["news_loader"](cfg, tok, base, dicts["val"], False, "cpu")
    assert len(train) == 2 and len(val) == 1

    class HostCopyOnly:
        """The train loader, with each batch's sample_idx as a NoNumpy tensor."""

        def __iter__(self):
            for b in train:
                assert b["sample_idx"].dtype == torch.int32 and b["pixels"].dtype == torch.float32
                b["sample_idx"] = b["sample_idx"].as_subclass(NoNumpy)
                yield b

    calls = []
    real = B.bart_forward
    monkeypatch.setattr(B, "bart_forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    g = make_generator(0)
    params = {"model": F.multimodal_bart_init(g, cfg.bart, cfg.fusion),
              "clip": clip_vision_init(g, cfg.clip)}
    init_fn, step_fn = make_train_step(cfg, 4, device="cpu")
    state = init_fn(params, B.bart_init(g, cfg.bart), 0)
    out_dir = tmp_path / "run"
    state = TL.fit(cfg, state, step_fn, HostCopyOnly(), val, str(out_dir), tokenizer=tok)
    assert state.step == 4 and len(calls) == 2  # epoch 2 runs from the teacher cache
    lines = [json.loads(x) for x in (out_dir / "run.metrics.jsonl").read_text().splitlines()]
    assert all(math.isfinite(v) for x in lines for v in x.values() if isinstance(v, float))
    assert sum("margin_loss" in x for x in lines) == 4
    for sub in ("best", "last"):
        assert any(n.isdigit() for n in os.listdir(out_dir / sub))
    vo = json.loads((out_dir / "val_outputs.json").read_text())
    assert vo["0"]["gt_cap"] == [ascii_fold(r["caption"]) for r in dicts["val"].values()]
    assert all(isinstance(s, str) for s in vo["0"]["logit_output"])
    caps = TL.generate_captions(cfg, state.params, val, tok, device="cpu")
    assert len([k for k in caps if k not in ("bleu", "other metrics")]) == 2
