"""The port's command line end to end on the CPU (`--device cpu`), on
tests/test_cli_end_to_end.py's fixture (its BPE vocab and 6-row GoodNews
dataset at 32 px):

* `train --config tiny --max-steps 3`, `generate` from best/, `evaluate`:
  the files and keys JAX's test checks;
* `generate` is token-identical to JAX's `generate_captions` (its Pallas
  decode and encoder kernels selected, interpret mode) on the same tiny tree,
  carried across and saved in the port's checkpoint format, over the same
  data dict, through the template restore and through its raw fallback; the
  output files are equal;
* `evaluate` and `lmm --backend echo` give JAX's CLI's output files (and
  printed metrics) exactly (`retrieve`: tests/test_torch_preprocess.py);
* `train --init-bart` merges a tiny .npz: the teacher and the model's BART
  leaves equal the file's, the NER table is re-seeded from its shared rows,
  the fusion attentions are re-tied, and no tensor is shared between the
  trained tree and the frozen teacher;
* `serve` as a subprocess (chip_smoke.py's serve_cli_roundtrip, the card's
  check, here with --device cpu): requests equal a direct generate_mm, a
  newer checkpoint is hot-swapped, SIGINT exits 0;
* `generate --sharded` over a 2-way CPU mesh writes the file one device
  writes; `serve --sharded` serves as a subprocess (a 1-device CPU mesh)
  and rounds its buckets up to multiples of a 4-way data axis;
* refusals: without a card and without `--device cpu`, every subcommand that
  touches a tensor exits naming the device, `--sharded` included (the mesh
  never falls back to the CPU).

Tolerance: exact (tokens, files, metrics)."""

import dataclasses
import json
import os
import runpy
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from tests.test_cli_end_to_end import _write_dataset, _write_vocab
from vacnic_tpu import cli as jcli
from vacnic_tpu.core.config import VacnicConfig as JCfg
from vacnic_tpu.data.tokenize import BartBpeTokenizer as JBpe
from vacnic_tpu.models import clip_vit as JV
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train import loop as JL
from vacnic_tpu_torch import cli
from vacnic_tpu_torch import serve as serve_mod
from vacnic_tpu_torch.convert_checkpoint import load_tree, save_tree
from vacnic_tpu_torch.core.config import VacnicConfig
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.data.synthetic import synthetic_batch
from vacnic_tpu_torch.infer import generate as G
from vacnic_tpu_torch.infer.generate import generate_mm
from vacnic_tpu_torch.models import bart as B
from vacnic_tpu_torch.models import fusion as F
from vacnic_tpu_torch.models.clip_vit import clip_vision_init
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import checkpoints as TC
from vacnic_tpu_torch.train import loop as TL
from vacnic_tpu_torch.train.train_step import (TrainState, create_mask, face_mask_from_emb,
                                               make_train_step)

REPO = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")
SPLIT = "{}_dict_newsmep_ent_clip8sent_contras_name_pos.json"


def _overrides(model_vocab: int) -> list[str]:
    """tests/test_cli_end_to_end.py's --set list."""
    sets = [f"bart.vocab_size={model_vocab}", f"fusion.ner_vocab_size={model_vocab}",
            "fusion.face_feature_dim=8", "train.train_batch_size=2", "train.val_batch_size=2",
            "train.num_epochs=1", "data.num_workers=2", "data.dataset=goodnews",
            "clip.image_size=32", "clip.patch_size=16", "clip.width=32", "clip.layers=1",
            "clip.heads=4", "decode.num_beams=2", "decode.max_length=8"]
    return [x for s in sets for x in ("--set", s)]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    vocab, merges, vocab_size = _write_vocab(root)
    data_dir = _write_dataset(root)
    test_dict = os.path.join(data_dir, "GoodNews", SPLIT.format("test"))
    return root, vocab, merges, vocab_size + 8, data_dir, test_dict


def _cfgs(model_vocab: int, data_dir: str):
    sets = _overrides(model_vocab)[1::2]
    jcfg = jcli._apply_overrides(JCfg.tiny(), sets)
    jcfg = dataclasses.replace(jcfg, data=dataclasses.replace(jcfg.data, data_dir=data_dir))
    tcfg = VacnicConfig.from_json(jcfg.to_json())
    assert tcfg == cli._apply_overrides(
        dataclasses.replace(VacnicConfig.tiny(), data=tcfg.data), sets)
    return jcfg, tcfg


def test_cli_train_generate_evaluate(fixture, tmp_path, capsys):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    out_dir = str(tmp_path / "out")
    rc = cli.main(["--device", "cpu", "train", "--config", "tiny", "--data-dir", data_dir,
                   "--out-dir", out_dir, "--vocab", vocab, "--merges", merges,
                   "--max-steps", "3"] + _overrides(model_vocab))
    assert rc == 0
    with open(os.path.join(out_dir, "test_captions.json")) as f:
        caps = json.load(f)
    assert "bleu" in caps and "other metrics" in caps
    assert "bleu1" in capsys.readouterr().out
    for sub in ("best", "last"):
        assert any(n.isdigit() for n in os.listdir(os.path.join(out_dir, sub)))

    gen_out = str(tmp_path / "gen.json")
    rc = cli.main(["generate", "--device", "cpu", "--ckpt-dir", os.path.join(out_dir, "best"),
                   "--data-dict", test_dict, "--vocab", vocab, "--merges", merges,
                   "--out", gen_out])
    assert rc == 0
    with open(gen_out) as f:
        gen = json.load(f)
    sample = [v for k, v in gen.items() if k not in ("bleu", "other metrics")][0]
    assert set(sample) == {"gt", "gen"} and "alice" in sample["gt"]

    rc = cli.main(["evaluate", "--results", gen_out, "--out", str(tmp_path / "report.json")])
    assert rc == 0
    report = json.loads((tmp_path / "report.json").read_text())
    assert "entities" in report and report["entities"]["ner_engine"] == "heuristic"


def _in_order(tree, like):
    """`tree` with its dicts' keys in `like`'s order."""
    if isinstance(like, dict):
        return {k: _in_order(tree[k], v) for k, v in like.items()}
    if isinstance(like, tuple):
        return tuple(_in_order(t, v) for t, v in zip(tree, like))
    return tree


@pytest.fixture
def threefry():
    prev = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", prev)


@pytest.mark.parametrize("restore", ["template", "raw"])
def test_generate_matches_jax_generate_captions(fixture, tmp_path, monkeypatch, threefry,
                                                restore):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    jcfg, tcfg = _cfgs(model_vocab, data_dir)
    rng = np.random.RandomState(1)
    # a wider weight spread than the init's 0.02, so the beams choose varied tokens
    jmodel = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.3 * rng.randn(*np.shape(x)).astype(np.float32),
        JF.multimodal_bart_init(jax.random.PRNGKey(0), jcfg.bart, jcfg.fusion))
    jclip = jax.tree_util.tree_map(np.asarray, JV.clip_vision_init(jax.random.PRNGKey(1),
                                                                   jcfg.clip))
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
    jtok = JBpe(vocab, merges)
    jtok.add_special_tokens(cli.SPECIAL_TOKENS)
    (jloader,) = jcli._make_loaders(jcfg, jtok, [(test_dict, False)])
    JL.generate_captions(jcfg, {"model": jmodel, "clip": jclip}, jloader, jtok,
                         out_path=str(tmp_path / "jax.json"))

    tparams = {"model": params_from_jax(jmodel), "clip": params_from_jax(jclip)}
    if restore == "template":  # the whole TrainState, as cli train saves it
        # jax's tree_map sorts dict keys; the template keeps the port's init order
        tparams = _in_order(tparams, cli._init_inference_params(tcfg, torch.device("cpu"))[1])
        init_fn, _ = make_train_step(tcfg, 1, device="cpu")
        state = init_fn(tparams, B.bart_init(make_generator(0), tcfg.bart), 0)
    else:  # a tree the template cannot predict: an extra subtree, no teacher
        state = TrainState(step=1, params=dict(tparams, clip_text={"w": torch.ones(2)}),
                           teacher={}, opt_state={}, rng=0)
    ckpt = str(tmp_path / "ckpt")
    TC.CheckpointManager(ckpt, tcfg).save(1, state)
    raw_reads = []
    real_raw = TC.CheckpointManager.restore_raw
    monkeypatch.setattr(TC.CheckpointManager, "restore_raw",
                        lambda self, *a: raw_reads.append(a) or real_raw(self, *a))
    rc = cli.main(["--device", "cpu", "generate", "--ckpt-dir", ckpt, "--data-dict", test_dict,
                   "--vocab", vocab, "--merges", merges, "--out", str(tmp_path / "port.json")])
    assert rc == 0
    assert len(raw_reads) == (restore == "raw")
    assert len(tokens["port"]) == len(tokens["jax"]) == 3
    for a, b in zip(tokens["port"], tokens["jax"]):
        np.testing.assert_array_equal(a, b)
    assert len(np.unique(np.concatenate(tokens["port"]))) > 4
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()


def _results(data_dict: dict) -> dict:
    rows = list(data_dict.values())
    gens = ["alice smith waving in paris", "the crowd in london", "a photo of bob",
            "press photo shows paris", "smith today", "gathered crowd"]
    out = {str(i): {"gt": r["caption"], "gen": gens[i % len(gens)]} for i, r in enumerate(rows)}
    out["bleu"] = {"bleu1": 0.0}
    return out


@pytest.mark.parametrize("with_gtent,with_data", [(False, False), (True, False), (True, True)])
def test_evaluate_matches_jax_cli(fixture, tmp_path, capsys, with_gtent, with_data):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    with open(test_dict) as f:
        dd = json.load(f)
    results = tmp_path / "results.json"
    results.write_text(json.dumps(_results(dd)))
    gtent = tmp_path / "gtent.json"
    gtent.write_text(json.dumps({h: {"ner_cap": r["names"] + r["gpe_loc"],
                                     "names_cap": r["names"], "org_cap": [],
                                     "gpe_cap": r["gpe_loc"]} for h, r in dd.items()}))
    extra = (["--gtent", str(gtent)] if with_gtent else []) + (
        ["--data-dict", test_dict] if with_data else [])
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        assert main(["evaluate", "--results", str(results), "--out",
                     str(tmp_path / f"{name}.json")] + extra) == 0
    printed = capsys.readouterr().out
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    report = json.loads((tmp_path / "port.json").read_text())
    assert ("face_groups" in report) == with_data and printed.count('"entities"') >= 2


@pytest.mark.parametrize("use_retrieval", [False, True])
def test_lmm_echo_matches_jax_cli(fixture, tmp_path, capsys, use_retrieval):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    base = os.path.join(data_dir, "GoodNews", "goodnews")
    os.makedirs(os.path.join(base, "articles_full"), exist_ok=True)
    with open(test_dict) as f:
        for h, rec in json.load(f).items():  # read in place of sents_byclip without retrieval
            with open(os.path.join(base, "articles_full", f"{h}.txt"), "w") as g:
                g.write(rec["sents_byclip"] + " Full text.")
    printed = {}
    for name, main in (("jax", jcli.main), ("port", cli.main)):
        args = ["lmm", "--backend", "echo", "--data-dict", test_dict, "--data-base-dir", base,
                "--batch-size", "4", "--out", str(tmp_path / f"{name}.json")]
        assert main(args + (["--use-retrieval"] if use_retrieval else [])) == 0
        printed[name] = capsys.readouterr().out.strip().splitlines()[-1]
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert printed["port"] == printed["jax"]
    assert len(json.loads((tmp_path / "port.json").read_text())) == 2  # 6 rows by 4


@pytest.mark.parametrize("tie", [True, False])
def test_train_init_bart_merges_the_file(fixture, tmp_path, monkeypatch, tie):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    _, tcfg = _cfgs(model_vocab, data_dir)
    g = make_generator(11)
    pretrained = B.bart_init(g, tcfg.bart)
    pretrained["final_logits_bias"] = torch.randn(pretrained["final_logits_bias"].shape,
                                                  generator=g)
    npz = str(tmp_path / "bart.npz")
    save_tree(pretrained, npz)
    want = load_tree(npz)
    seen = {}

    def no_fit(cfg, state, *a, **k):  # the merged state, before any step moves it
        seen["state"] = state
        return state

    monkeypatch.setattr(TL, "fit", no_fit)
    rc = cli.main(["--device", "cpu", "train", "--config", "tiny", "--data-dir", data_dir,
                   "--out-dir", str(tmp_path / "out"), "--vocab", vocab, "--merges", merges,
                   "--init-bart", npz, "--set", f"fusion.init_attn_weight={tie}"]
                  + _overrides(model_vocab))
    assert rc == 0
    state = seen["state"]
    m = state.params["model"]
    for (path, t), (_, w) in zip(leaves_with_path(state.teacher), leaves_with_path(want)):
        assert torch.equal(t, w), path
    assert torch.equal(m["shared"]["weight"], want["shared"]["weight"])
    assert torch.equal(m["final_logits_bias"], want["final_logits_bias"])
    for side in ("encoder", "decoder"):
        for k, v in want[side].items():
            if k != "layers":
                for (path, a), (_, b) in zip(leaves_with_path(m[side][k]), leaves_with_path(v)):
                    assert torch.equal(a, b), (side, k, path)
        for ours, theirs in zip(m[side]["layers"], want[side]["layers"]):
            for k, v in theirs.items():
                for (path, a), (_, b) in zip(leaves_with_path(ours[k]), leaves_with_path(v)):
                    assert torch.equal(a, b), (side, k, path)
    ner = m["encoder"]["embed_tokens_ner"]["weight"]
    n = min(ner.shape[0], want["shared"]["weight"].shape[0], 50265)
    assert torch.equal(ner[:n], want["shared"]["weight"][:n])
    for i in tcfg.fusion.fusion_layers:
        lp = m["encoder"]["layers"][i]
        for name in ("cross_attn_img_ner", "self_attn_img_name"):
            same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
                leaves_with_path(lp[name]), leaves_with_path(lp["self_attn"])))
            assert same == tie, (i, name)
    trained = {t.data_ptr() for _, t in leaves_with_path(state.params)}
    assert not trained & {t.data_ptr() for _, t in leaves_with_path(state.teacher)}


def test_serve_subprocess_hot_swaps_and_exits_on_sigint(tmp_path):
    cfg = VacnicConfig.tiny()
    params = {"model": F.multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion),
              "clip": clip_vision_init(make_generator(1), cfg.clip)}
    ckpt = str(tmp_path / "ckpt")
    mgr = TC.CheckpointManager(ckpt, cfg)
    mgr.save(0, TrainState(step=0, params=params, teacher={}, opt_state={}, rng=0))
    b = synthetic_batch(cfg, 2, seed=7)
    keys = ("article_ids", "image_cls", "face_emb", "names_art_ids")
    rows = [{k: b[k][i].numpy() for k in keys} for i in range(2)]

    def direct(row):
        x = {k: torch.from_numpy(row[k])[None] for k in row}
        return generate_mm(params["model"], x["article_ids"], create_mask(x["article_ids"]),
                           x["image_cls"], cfg.bart, cfg.fusion, cfg.decode,
                           face_features=x["face_emb"], face_mask=face_mask_from_emb(x["face_emb"]),
                           name_ids=x["names_art_ids"], name_mask=create_mask(x["names_art_ids"]),
                           dtype=torch.float32, device="cpu")

    r = SMOKE["serve_cli_roundtrip"](
        ckpt, rows, direct,
        lambda: mgr.save(1, TrainState(step=1, params=params, teacher={}, opt_state={}, rng=0)),
        str(tmp_path / "serve.log"), args=("--device", "cpu"), start_timeout=120)
    assert r["exit"] == 0 and len(r["request_ms"]) == 3
    log = (tmp_path / "serve.log").read_text()
    assert "restored checkpoint at step 0" in log and "watching" in log


@pytest.mark.parametrize("argv", [
    ["smoke"],
    ["train", "--data-dir", "d", "--out-dir", "o", "--vocab", "v", "--merges", "m"],
    ["generate", "--ckpt-dir", "c", "--data-dict", "d", "--vocab", "v", "--merges", "m",
     "--out", "o"],
    ["serve", "--random-init"],
    ["retrieve", "--data-dict", "d", "--data-base-dir", "b", "--clip-ckpt", "c",
     "--clip-vocab", "v", "--out", "o"],
    ["lmm", "--backend", "llava", "--data-dict", "d", "--data-base-dir", "b", "--out", "o"],
])
def test_cli_refuses_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device"):
        cli.main(argv)


@pytest.mark.parametrize("cmd", [
    ["generate", "--ckpt-dir", "c", "--data-dict", "d", "--vocab", "v", "--merges", "m",
     "--out", "o"],
    ["serve", "--random-init"],
])
def test_sharded_is_refused(cmd):
    """--sharded spreads over every visible card: without one, and without
    --device cpu, it exits naming the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(SystemExit, match="--device cuda: no CUDA device"):
        cli.main(cmd + ["--sharded"])


def test_generate_sharded_writes_the_one_device_file(fixture, tmp_path, monkeypatch, capsys):
    root, vocab, merges, model_vocab, data_dir, test_dict = fixture
    _, tcfg = _cfgs(model_vocab, data_dir)
    _, params = cli._init_inference_params(tcfg, torch.device("cpu"))
    ckpt = str(tmp_path / "ckpt")
    TC.CheckpointManager(ckpt, tcfg).save(0, TrainState(step=0, params=params, teacher={},
                                                        opt_state={}, rng=0))
    argv = ["--device", "cpu", "generate", "--ckpt-dir", ckpt, "--data-dict", test_dict,
            "--vocab", vocab, "--merges", merges]
    assert cli.main(argv + ["--out", str(tmp_path / "one.json")]) == 0
    monkeypatch.setattr(cli, "_mesh_devices", lambda dev: [dev, dev])
    calls = []
    monkeypatch.setattr(TL, "generate_mm_sharded",
                        lambda *a, **kw: calls.append(1) or G.generate_mm_sharded(*a, **kw))
    capsys.readouterr()
    assert cli.main(argv + ["--out", str(tmp_path / "mesh.json"), "--sharded"]) == 0
    assert "sharded decode over 2 devices" in capsys.readouterr().err
    assert calls  # the batches went through the mesh
    assert (tmp_path / "mesh.json").read_text() == (tmp_path / "one.json").read_text()


def test_serve_sharded_rounds_the_buckets(monkeypatch, capsys):
    served = []
    monkeypatch.setattr(cli, "_mesh_devices", lambda dev: [dev] * 4)
    monkeypatch.setattr(serve_mod, "http_serve", lambda svc, **kw: served.append(svc))
    assert cli.main(["--device", "cpu", "serve", "--random-init", "--config", "tiny",
                     "--buckets", "1,8,30", "--no-precompile", "--sharded"]) == 0
    err = capsys.readouterr().err
    assert "sharded serving over 4 devices" in err
    assert "buckets [1, 8, 30] -> [4, 8, 32] (rounded up to multiples of the 4-way data axis)" \
        in err
    (svc,) = served
    assert svc.scfg.buckets == (4, 8, 32) and svc.mesh.shape == {"data": 4, "model": 1}
    assert svc._closed.is_set()  # cmd_serve closed it after the serve loop returned


def test_serve_sharded_subprocess(tmp_path):
    """`cli serve --sharded` as a user runs it (chip_smoke's roundtrip, as
    test_serve_subprocess_hot_swaps_and_exits_on_sigint): over --device
    cpu's one-device mesh, requests equal a direct generate_mm, a newer
    checkpoint reaches the replica, SIGINT exits 0."""
    cfg = VacnicConfig.tiny()
    params = {"model": F.multimodal_bart_init(make_generator(0), cfg.bart, cfg.fusion),
              "clip": clip_vision_init(make_generator(1), cfg.clip)}
    ckpt = str(tmp_path / "ckpt")
    mgr = TC.CheckpointManager(ckpt, cfg)
    mgr.save(0, TrainState(step=0, params=params, teacher={}, opt_state={}, rng=0))
    b = synthetic_batch(cfg, 2, seed=7)
    keys = ("article_ids", "image_cls", "face_emb", "names_art_ids")
    rows = [{k: b[k][i].numpy() for k in keys} for i in range(2)]

    def direct(row):
        x = {k: torch.from_numpy(row[k])[None] for k in row}
        return generate_mm(params["model"], x["article_ids"], create_mask(x["article_ids"]),
                           x["image_cls"], cfg.bart, cfg.fusion, cfg.decode,
                           face_features=x["face_emb"], face_mask=face_mask_from_emb(x["face_emb"]),
                           name_ids=x["names_art_ids"], name_mask=create_mask(x["names_art_ids"]),
                           dtype=torch.float32, device="cpu")

    r = SMOKE["serve_cli_roundtrip"](
        ckpt, rows, direct,
        lambda: mgr.save(1, TrainState(step=1, params=params, teacher={}, opt_state={}, rng=0)),
        str(tmp_path / "serve.log"), args=("--device", "cpu"), start_timeout=120,
        serve_args=("--sharded",))
    assert r["exit"] == 0 and len(r["request_ms"]) == 3
    assert "sharded serving over 1 devices" in (tmp_path / "serve.log").read_text()


@pytest.mark.parametrize("where", ["before", "after"])
def test_smoke_on_the_cpu(capsys, where):
    argv = ["--device", "cpu", "smoke"] if where == "before" else ["smoke", "--device", "cpu"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "smoke ok" in out and out.count("step ") == 3
