"""The mlp prompt mapper (prompt_mlp_type="mlp": linears over the patch
dimension of CLIP's patch tokens) and extract_visual_prompt of the port
(vacnic_tpu_torch/models/fusion.py) against the JAX package
(vacnic_tpu/models/fusion.py), f32 on the CPU, inputs from numpy seeds and
JAX's trees carried across with weights_io.params_from_jax:

* prompt_mlp_patch_fwd, square and non-square map sizes: within 1e-5, and a
  transpose in place of the reference's reshape is caught;
* multimodal_bart_init's mlp tree: JAX's paths and shapes, d_model 1024's
  visual_map included;
* mm_encoder_fwd, mm_encoder_fwd_fused and mm_forward with the mlp mapper,
  full and only_image: within 1e-4 (the tests/test_torch_encoder.py
  tolerance);
* generate_mm with the mlp mapper against JAX's with its Pallas encoder and
  decode selected (interpret mode): tokens identical, scores within 1e-5;
* extract_visual_prompt: JAX's values, no gradient;
* the tensor-parallel step (tp 2, two gloo processes) on an mlp config,
  against one process: loss terms within 2e-5 and every gradient leaf
  within 1e-5 of its largest (tests/test_torch_tensor_parallel.py's
  tolerances), the mapper's stages replicated."""

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conftest import assert_close
from vacnic_tpu.core.config import BartConfig as JBart, FusionConfig as JFusion
from vacnic_tpu.core.config import VacnicConfig as JC
from vacnic_tpu.data.synthetic import synthetic_batch as j_batch
from vacnic_tpu.infer.generate import generate_mm as j_generate
from vacnic_tpu.models import bart as JB
from vacnic_tpu.models import fusion as JF
from vacnic_tpu.train.train_step import create_mask as j_mask, face_mask_from_emb as j_face
from vacnic_tpu_torch.core import tensor_parallel as TP
from vacnic_tpu_torch.core.config import (PORT_ONLY_BART_FIELDS, BartConfig, FusionConfig,
                                          VacnicConfig as TC)
from vacnic_tpu_torch.core.rng import make_generator
from vacnic_tpu_torch.core.tree import leaves_with_path
from vacnic_tpu_torch.infer.generate import generate_mm as t_generate
from vacnic_tpu_torch.kernels import primitives as K
from vacnic_tpu_torch.models import fusion as TF
from vacnic_tpu_torch.models.layers import split
from vacnic_tpu_torch.models.weights_io import params_from_jax
from vacnic_tpu_torch.train import train_step as TT

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # the spawned ranks import chip_smoke by name
    sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

# n_patches, stage widths, prompt rows; the tiny model is 32 wide, so are its patches
MAP_SIZE = (6, 8, 5, 3)
WIDTH = 32


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def configs(only_image: bool = False, map_size=MAP_SIZE):
    """VacnicConfig.tiny with the mlp mapper, in both packages."""
    out = []
    for C in (JC, TC):
        c = C.tiny(only_image=only_image)
        out.append(dataclasses.replace(c, fusion=dataclasses.replace(
            c.fusion, prompt_mlp_type="mlp", map_size=map_size)))
    return out


def patches(bsz: int, n_patches: int, width: int = WIDTH, seed: int = 7) -> np.ndarray:
    return np.random.RandomState(seed).randn(bsz, n_patches, width).astype(np.float32)


def perturbed(jp, scale: float, seed: int):
    """JAX's tree with a wider spread than the init's 0.02 (numpy draws), as
    numpy leaves."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + scale * rng.randn(*np.shape(x)).astype(np.float32), jp)


@pytest.mark.parametrize("map_size", [(6, 8, 5, 3), (4, 4, 4), (9, 2)],
                         ids=["non_square", "square", "one_stage"])
def test_patch_mapper_matches_jax(map_size):
    """Every stage and the tanh between them (none after the last); with
    n_patches != width the reshape is not a transpose, and a transpose
    gives another answer."""
    jp = perturbed(JF.prompt_mlp_patch_init(jax.random.PRNGKey(1), map_size), 0.3, 2)
    x = patches(3, map_size[0])
    want = np.asarray(JF.prompt_mlp_patch_fwd(jp, x))
    tp = params_from_jax(jp)
    got = TF.prompt_mlp_patch_fwd(tp, torch.from_numpy(x))
    assert got.shape == (3, map_size[-1], WIDTH) == want.shape
    assert_close(got, want, atol=1e-5, rtol=1e-5)
    # a non-contiguous input reshapes by its values, as numpy does
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(1, 2)
    assert not xt.is_contiguous()
    assert torch.equal(TF.prompt_mlp_patch_fwd(tp, xt), got)
    # the transpose a port might write in place of the reshape
    wrong = torch.from_numpy(x).transpose(1, 2)
    for i, stage in enumerate(tp["stages"]):
        wrong = wrong @ stage["kernel"] + stage["bias"]
        wrong = torch.tanh(wrong) if i < len(tp["stages"]) - 1 else wrong
    wrong = wrong.transpose(1, 2)
    assert float((wrong - got).abs().max()) > 1e-2


@pytest.mark.parametrize("d_model", [32, 1024])
@pytest.mark.parametrize("only_image", [False, True], ids=["full", "onlyimg"])
def test_init_tree_matches_jax(only_image, d_model):
    """multimodal_bart_init(prompt_mlp_type="mlp"): JAX's tree, paths and
    shapes, the stages as a tuple, visual_map at d_model 1024."""
    bart = BartConfig.tiny(d_model=d_model, encoder_layers=1, decoder_layers=1,
                           encoder_ffn_dim=64, decoder_ffn_dim=64)
    fus = FusionConfig.tiny(fusion_layers=(0,), dim_common=d_model, prompt_mlp_type="mlp",
                            map_size=(196, 256, 64, 16), only_image=only_image)
    jbart = JBart(**{k: v for k, v in dataclasses.asdict(bart).items()
                     if k not in PORT_ONLY_BART_FIELDS})  # LED's: the port's own
    jfus = JFusion(**dataclasses.asdict(fus))
    shapes = jax.eval_shape(lambda k: JF.multimodal_bart_init(k, jbart, jfus),
                            jax.random.PRNGKey(0))
    tp = TF.multimodal_bart_init(make_generator(0), bart, fus)
    jflat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    tflat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: np.empty(a.shape), tp,
                               is_leaf=lambda a: isinstance(a, torch.Tensor)))[0]
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [jax.tree_util.keystr(p) for p, _ in tflat]
    assert [tuple(a.shape) for _, a in jflat] == [tuple(a.shape) for _, a in tflat]
    stages = tp["encoder"]["prompt_mlp"]["stages"]
    assert isinstance(stages, tuple) and [tuple(s["kernel"].shape) for s in stages] == [
        (196, 256), (256, 64), (64, 16)]
    assert ("visual_map" in tp["encoder"]) == (d_model == 1024)


def test_clipcap_init_keeps_the_tree():
    """prompt_mlp_clipcap_init draws what multimodal_bart_init drew before
    it was a function of its own: the seeded trees (and the captions the
    card's runs compare across trees) stay the same."""
    cfg = TC.tiny()
    tree = TF.multimodal_bart_init(make_generator(3), cfg.bart, cfg.fusion)
    g = make_generator(3)
    bart = TF.B.bart_init(g, cfg.bart)
    for i in range(cfg.bart.encoder_layers):
        TF.fusion_encoder_layer_init(g, cfg.bart, cfg.fusion, i in cfg.fusion.fusion_layers)
    mapper = TF.prompt_mlp_clipcap_init(g, cfg.fusion.img_size, cfg.fusion.prompt_size)
    assert torch.equal(bart["shared"]["weight"], tree["shared"]["weight"])
    for k in ("prompt_fc1", "prompt_fc2"):
        assert torch.equal(mapper[k]["kernel"], tree["encoder"]["prompt_mlp"][k]["kernel"])


@pytest.fixture(scope="module", params=[False, True], ids=["full", "onlyimg"])
def model(request):
    """(JAX args, JAX kwargs, port args, port kwargs, configs) of an mlp
    tiny model on a batch of 3 with patch tokens."""
    only = request.param
    jcfg, tcfg = configs(only)
    jp = perturbed(JF.multimodal_bart_init(jax.random.PRNGKey(0), jcfg.bart, jcfg.fusion),
                   0.1, 0)
    jb = j_batch(jcfg, 3, seed=0)
    x = patches(3, MAP_SIZE[0])
    jkw = tkw = {}
    if not only:
        jkw = dict(face_features=jb["face_emb"], face_mask=j_face(jb["face_emb"]),
                   name_ids=jb["names_art_ids"], name_mask=j_mask(jb["names_art_ids"]))
        tkw = {k: torch.from_numpy(np.array(v)) for k, v in jkw.items()}
    ids = np.array(jb["article_ids"])
    jargs = (jp, jb["article_ids"], j_mask(jb["article_ids"]), x, jcfg.bart, jcfg.fusion)
    targs = (params_from_jax(jp), torch.from_numpy(ids),
             torch.from_numpy(np.array(j_mask(jb["article_ids"]))), torch.from_numpy(x),
             tcfg.bart, tcfg.fusion)
    return jargs, jkw, targs, tkw, (jcfg, tcfg)


def test_encoders_match_jax(model):
    """The layer-by-layer and the fused encoder (KV = map_size[-1] prompt
    rows, + max_ner_type_len_gt without only_image) against JAX's."""
    jargs, jkw, targs, tkw, (_, tcfg) = model
    ref = JF.mm_encoder_fwd(*jargs, **jkw)
    assert TF.fused_encoder_eligible(tcfg.fusion, tcfg.bart, True)
    before = K.launch_counts()
    for fwd in (TF.mm_encoder_fwd, TF.mm_encoder_fwd_fused):
        out = fwd(*targs, **tkw)
        assert out["img"].shape == (3, MAP_SIZE[-1], tcfg.bart.d_model)
        for k in ("last_hidden", "img", "ner", "face"):
            if ref[k] is not None:
                assert_close(out[k], ref[k], msg=f"{fwd.__name__} {k}")
    assert K.launch_counts() == before  # CPU tensors: the plain twins
    _, _, cross_k, cross_v, _, cross_bias, _ = TF._fused_encoder_prologue(*targs, **tkw)
    kv = MAP_SIZE[-1] + (0 if tcfg.fusion.only_image else tcfg.fusion.max_ner_type_len_gt)
    assert cross_k.shape[-1] == cross_v.shape[2] == cross_bias.shape[1] == kv


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "layerwise"])
def test_mm_forward_matches_jax(model, fused):
    jargs, jkw, targs, tkw, (jcfg, _) = model
    dec_in = np.random.RandomState(4).randint(3, jcfg.bart.vocab_size, (3, 7)).astype(np.int32)
    jp, ids, mask, img, bart, fus = jargs
    ref = JF.mm_forward(jp, ids, mask, dec_in, img, bart, fus, **jkw)
    tp_, tids, tmask, timg, tbart, tfus = targs
    out = TF.mm_forward(tp_, tids, tmask, torch.from_numpy(dec_in), timg, tbart, tfus,
                        allow_fused_encoder=fused, device="cpu", **tkw)
    for k in ("logits", "encoder_hidden", "hidden_states_img"):
        assert_close(out[k], ref[k], msg=k)


def test_generate_mm_matches_jax(model, monkeypatch):
    """Beam search over the mlp model: tokens identical, scores within 1e-5,
    against JAX's generate_mm with its Pallas encoder and decode selected
    (interpret mode), the paths the port's kernels replace."""
    jargs, jkw, targs, tkw, (jcfg, tcfg) = model
    monkeypatch.setenv("VACNIC_PALLAS_DECODE", "1")
    monkeypatch.setenv("VACNIC_PALLAS_ENCODER", "1")
    jargs = (perturbed(jargs[0], 0.3, 5),) + jargs[1:]
    targs = (params_from_jax(jargs[0]),) + targs[1:]
    dec = dict(max_length=10)
    js, jsc = j_generate(*jargs, dataclasses.replace(jcfg.decode, **dec), **jkw)
    ts, tsc = t_generate(*targs, dataclasses.replace(tcfg.decode, **dec), device="cpu", **tkw)
    assert ts.shape == (3, 10)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-5, atol=1e-5)
    assert len(np.unique(ts.numpy())) > 4  # the beams chose varied tokens


@pytest.mark.parametrize("mapper", ["mlp", "clipcap"])
def test_extract_visual_prompt(mapper):
    """JAX's values, moved to the device asked for, without a gradient even
    from leaves that require one."""
    jcfg, tcfg = configs()
    if mapper == "clipcap":
        jcfg, tcfg = JC.tiny(), TC.tiny()
    jp = perturbed(JF.multimodal_bart_init(jax.random.PRNGKey(2), jcfg.bart, jcfg.fusion),
                   0.1, 3)
    x = (patches(2, MAP_SIZE[0]) if mapper == "mlp"
         else np.random.RandomState(8).randn(2, tcfg.fusion.img_size).astype(np.float32))
    want = np.asarray(JF.extract_visual_prompt(jp, x, jcfg.bart, jcfg.fusion))
    tp = params_from_jax(jp)
    for _, leaf in leaves_with_path(tp["encoder"]["prompt_mlp"]):
        leaf.requires_grad_(True)
    got = TF.extract_visual_prompt(tp, x, tcfg.bart, tcfg.fusion, device="cpu")
    assert not got.requires_grad and got.device.type == "cpu"
    assert got.shape == want.shape
    assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_mapper_stages_are_replicated():
    """The sharding rule cuts no leaf of the mlp mapper (a stage's parent is
    a tuple index, which names no column or row tag), as JAX's
    param_shardings leaves them whole; so shard_params keeps them whole."""
    _, tcfg = configs()
    tree = TF.multimodal_bart_init(make_generator(0), tcfg.bart, tcfg.fusion)
    sharded = TP.shard_params(tree, TP.ModelShard(1, 2))
    for s, w in zip(sharded["encoder"]["prompt_mlp"]["stages"],
                    tree["encoder"]["prompt_mlp"]["stages"]):
        for k in ("kernel", "bias"):
            assert s[k] is w[k]
    assert not any(TP.is_cut(p, t) for p, t in leaves_with_path(sharded)
                   if "prompt_mlp" in p)


def test_tp2_step_with_mlp_mapper_matches_one_process(tmp_path):
    """Two gloo processes at tp 2 (chip_smoke.run_dp_group) train an mlp
    model on patch tokens: the loss terms of two steps within 2e-5 of one
    process, every gradient leaf within 1e-5 of its largest, the mapper's
    gradients among them."""
    jcfg, tcfg = configs()
    widths = dict(d_model=64, encoder_ffn_dim=128, decoder_ffn_dim=128,
                  encoder_attention_heads=4, decoder_attention_heads=4)
    jcfg, tcfg = (dataclasses.replace(
        c, bart=dataclasses.replace(c.bart, **widths),
        fusion=dataclasses.replace(c.fusion, dim_common=64),
        train=dataclasses.replace(c.train, no_clip_norm=False, clip_norm=1.0))
        for c in (jcfg, tcfg))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jp = to_np({"model": JF.multimodal_bart_init(keys[0], jcfg.bart, jcfg.fusion)})
    jt = to_np(JB.bart_init(keys[1], jcfg.bart))
    batch = {k: np.array(v) for k, v in j_batch(jcfg, 4, seed=1).items()}
    batch["image_cls"] = patches(4, MAP_SIZE[0], width=64)  # the mapper's patch tokens
    spec = dict(device="cpu", threads=1, params=params_from_jax(jp),
                teacher=params_from_jax(jt), rng=5, batch=batch,
                cases=[dict(cfg=tcfg, steps=2, grid=(1, 2), grads=True)])
    got = chip_smoke.run_dp_group(2, spec, str(tmp_path), 150)[0]

    init_fn, step_fn = TT.make_train_step(tcfg, 100, device="cpu")
    state = init_fn(params_from_jax(jp), params_from_jax(jt), 5)
    m, grads = TT.loss_and_grads(state.params, state.teacher, batch, tcfg,
                                 split(state.rng)[1])
    paths = [p for p, _ in leaves_with_path(state.params)]
    want_steps = []
    for _ in range(2):
        state, ms = step_fn(state, batch)
        want_steps.append({k: float(v) for k, v in ms.items()})
    for i, (g, w) in enumerate(zip(got["steps"], want_steps)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=2e-5, err_msg=f"step {i} {k}")
    assert got["tp"]["replicated_grads_agree"]
    errs = chip_smoke.grad_errors(paths, got["grads"], grads)
    stage_paths = [p for p in errs if "prompt_mlp" in p]
    assert len(stage_paths) == 2 * (len(MAP_SIZE) - 1), stage_paths
    assert all(e <= 1e-5 for e in errs.values()), max(errs.items(), key=lambda kv: kv[1])
    assert all(float(grads[paths.index(p)].abs().max()) > 0 for p in paths
               if "prompt_mlp" in p)
