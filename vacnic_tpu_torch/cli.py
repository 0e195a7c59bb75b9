"""Command-line entry point of the port (port of vacnic_tpu/cli.py): the
same subcommands, flags and output files, on the GPU.

  python -m vacnic_tpu_torch.cli train --config full|onlyvis|tiny --data-dir ... --out-dir ...
  python -m vacnic_tpu_torch.cli generate --ckpt-dir ... --data-dict ... --out ...
  python -m vacnic_tpu_torch.cli evaluate --results caption.json [--gtent dict.json]
  python -m vacnic_tpu_torch.cli serve --ckpt-dir ... | --random-init
  python -m vacnic_tpu_torch.cli retrieve --clip-ckpt clip.npz ...
  python -m vacnic_tpu_torch.cli lmm --backend echo ...
  python -m vacnic_tpu_torch.cli smoke  # small end-to-end self-check, no data needed

Any config field can be overridden with --set section.field=value.

`--device` (before or after the subcommand; "cuda" by default) is where
every subcommand that touches a tensor runs. Without a card, those
subcommands exit non-zero with a message naming the device unless given
`--device cpu`; nothing falls back. `generate` and `serve` read the port's
own checkpoints (train/checkpoints.CheckpointManager), `--init-bart` and
`--clip-ckpt` the .npz trees of `python -m vacnic_tpu_torch.convert_checkpoint`
(the JAX package's format). `generate --sharded` and `serve --sharded` run
data-parallel over every visible card (with `--device cpu`, over the one
CPU device), `serve` rounding its buckets up to multiples of the data axis;
the JAX CLI's `quality-rehearsal` is not ported.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

SPECIAL_TOKENS = ["<ENT>", "<NONAME>", "<PERSON>", "<ORGNORP>", "<GPELOC>"]


def _apply_overrides(cfg, overrides: list[str]):
    for item in overrides:
        path, _, raw = item.partition("=")
        section, _, field = path.partition(".")
        sub = getattr(cfg, section)
        old = getattr(sub, field)
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        elif isinstance(old, tuple):
            val = tuple(int(x) for x in raw.split(","))
        else:
            val = raw
        cfg = dataclasses.replace(cfg, **{section: dataclasses.replace(sub, **{field: val})})
    return cfg


def _preset(name: str):
    from vacnic_tpu_torch.core.config import VacnicConfig

    return {"full": VacnicConfig.full_train,
            "onlyvis": VacnicConfig.onlyvis_train,
            "tiny": VacnicConfig.tiny}[name]()


def _build_config(args):
    cfg = _preset(args.config)
    if getattr(args, "data_dir", None):
        cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, data_dir=args.data_dir))
    return _apply_overrides(cfg, args.set or [])


def _device(args):
    """The run's torch.device; exits with a message naming it when it is not
    usable here (a "cuda" run without a card)."""
    from vacnic_tpu_torch.core.device import resolve_device

    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"vacnic_tpu_torch.cli {args.cmd}: --device {args.device}: {e}")


def _mesh_devices(dev):
    """What --sharded spreads over: every visible card for a "cuda" run
    (None: make_mesh's default), the one CPU device for --device cpu."""
    return None if dev.type == "cuda" else [dev]


def _sharded_decode_mesh(dev, what: str):
    """Data-parallel mesh over `_mesh_devices(dev)` (shared by the --sharded
    paths of cmd_generate and cmd_serve)."""
    from vacnic_tpu_torch.core.config import MeshConfig
    from vacnic_tpu_torch.core.mesh import make_mesh

    mesh = make_mesh(MeshConfig(), devices=_mesh_devices(dev))
    print(f"sharded {what} over {mesh.size} devices", file=sys.stderr)
    return mesh


def _bart_tokenizer(vocab: str, merges: str):
    from vacnic_tpu_torch.data.tokenize import BartBpeTokenizer

    tokenizer = BartBpeTokenizer(vocab, merges)
    tokenizer.add_special_tokens(SPECIAL_TOKENS)
    return tokenizer


def _detached(tree, clone: bool = False):
    """The tree with every tensor detached from autograd (and copied, with
    `clone`)."""
    import torch

    from vacnic_tpu_torch.core.tree import tree_map

    def leaf(_, x):
        if not isinstance(x, torch.Tensor):
            return x
        return x.detach().clone() if clone else x.detach()

    return tree_map(leaf, tree)


def _smoke_config():
    """VacnicConfig.tiny() at widths the card's kernels take: head_dim 64
    (d 256 with 4 heads), products with N % 64 == 0, 64-token articles,
    and CLIP features as wide as the model, as tiny() has them."""
    from vacnic_tpu_torch.core.config import BartConfig, ClipVisionConfig, VacnicConfig

    tiny = VacnicConfig.tiny()
    return dataclasses.replace(
        tiny, bart=BartConfig.tiny(d_model=256, encoder_attention_heads=4,
                                   decoder_attention_heads=4, encoder_ffn_dim=512,
                                   decoder_ffn_dim=512),
        clip=ClipVisionConfig.tiny(width=256, heads=4),
        fusion=dataclasses.replace(tiny.fusion, dim_common=256, img_size=256),
        data=dataclasses.replace(tiny.data, article_max_length=64))


def cmd_smoke(args) -> int:
    """Small synthetic end-to-end: init -> 3 train steps -> beam decode."""
    import numpy as np
    import torch

    from vacnic_tpu_torch.core.rng import make_generator, set_random_seed
    from vacnic_tpu_torch.data.synthetic import synthetic_batch
    from vacnic_tpu_torch.data.tokenize import HashWordTokenizer
    from vacnic_tpu_torch.infer.generate import generate_mm
    from vacnic_tpu_torch.models import bart as B, fusion as F
    from vacnic_tpu_torch.models.layers import fold_in
    from vacnic_tpu_torch.train.train_step import create_mask, face_mask_from_emb, make_train_step

    dev = _device(args)
    cfg = _smoke_config()
    seed = set_random_seed(cfg.train.seed)
    params = {"model": F.multimodal_bart_init(make_generator(seed, dev), cfg.bart, cfg.fusion,
                                              device=dev)}
    teacher = B.bart_init(make_generator(fold_in(seed, 1), dev), cfg.bart, device=dev)
    init_fn, step_fn = make_train_step(cfg, 10, device=dev)
    state = init_fn(params, teacher, fold_in(seed, 2))
    batch = synthetic_batch(cfg, 4)
    for i in range(3):
        state, m = step_fn(state, batch)
        print(f"step {i}: loss {float(m['loss']):.4f} txt {float(m['txt_loss']):.4f}")
    dcfg = dataclasses.replace(cfg.decode, num_beams=3, max_length=8)
    seqs, _ = generate_mm(
        state.params["model"], batch["article_ids"], create_mask(batch["article_ids"]),
        batch["image_cls"], cfg.bart, cfg.fusion, dcfg,
        face_features=batch["face_emb"], face_mask=face_mask_from_emb(batch["face_emb"]),
        name_ids=batch["names_art_ids"], name_mask=create_mask(batch["names_art_ids"]),
        dtype=torch.float32, device=dev)
    tok = HashWordTokenizer(cfg.bart.vocab_size)
    print("decoded:", [tok.decode(row) for row in np.asarray(seqs.cpu())])
    print("smoke ok")
    return 0


def _make_loaders(cfg, tokenizer, split_paths, clip_tokenizer=None, device=None):
    from vacnic_tpu_torch.data.collate import collate
    from vacnic_tpu_torch.data.datasets import NewsCaptionDataset
    from vacnic_tpu_torch.data.pipeline import PrefetchLoader

    loaders = []
    for path, is_train in split_paths:
        with open(path) as f:
            data_dict = json.load(f)
        # reference directory layout (train...match.py:770-812):
        # DATADIR/GoodNews/goodnews/* per-sample files, DATADIR/GoodNews/*.json dicts
        base = {"goodnews": "GoodNews/goodnews", "nytimes": "NYTimes/nytimes"}[cfg.data.dataset]
        ds = NewsCaptionDataset(
            data_dict,
            os.path.join(cfg.data.data_dir, base),
            tokenizer,
            dataset=cfg.data.dataset,
            max_article_len=cfg.data.article_max_length,
            max_caption_len=cfg.data.caption_max_length,
            max_ner_type_len=cfg.fusion.max_ner_type_len,
            max_ner_type_len_gt=cfg.fusion.max_ner_type_len_gt,
            retrieved_sent=cfg.data.use_retrieval,
            train=is_train,
            image_size=cfg.clip.image_size,
            clip_tokenizer=clip_tokenizer,
        )
        noname = tokenizer.added_tokens.get("<NONAME>", 50266)
        loaders.append(
            PrefetchLoader(
                ds,
                cfg.train.train_batch_size if is_train else cfg.train.val_batch_size,
                lambda s, _n=noname: collate(
                    s, article_len=cfg.data.article_max_length,
                    caption_len=cfg.data.caption_max_length,
                    ner_len=cfg.fusion.max_ner_type_len,
                    ner_len_gt=cfg.fusion.max_ner_type_len_gt,
                    max_faces=cfg.fusion.max_faces,
                    face_dim=cfg.fusion.face_feature_dim,
                    noname_id=_n,
                ),
                shuffle=is_train,
                num_workers=cfg.data.num_workers,
                # eval loaders must see every sample: entity/face-group eval
                # aligns output entries to data-dict entries by position
                drop_last=is_train,
                device=device,
            )
        )
    return loaders


def _load_clip_vision_ckpt(path: str, vcfg):
    """Load a stock OR fine-tuned CLIP vision tower for `--clip-ckpt`
    (reference `--trained_clip CLIPNAME.pt`, train...match.py:736-739:
    torch.loads an externally tuned CLIP in OpenAI format). Accepts a
    converted .npz tree (`python -m vacnic_tpu_torch.convert_checkpoint
    clip`) or a raw OpenAI/HF torch checkpoint."""
    from vacnic_tpu_torch.convert_checkpoint import load_tree
    from vacnic_tpu_torch.models import weights_io as W

    if path.endswith(".npz"):
        tree = load_tree(path)
        return tree["vision"] if "vision" in tree else tree
    sd = W.load_state_dict(path)
    if any(k.startswith("visual.") for k in sd):
        return W.convert_clip_vision_openai(sd, vcfg)
    return W.convert_clip_vision_hf(sd, vcfg)


def cmd_train(args) -> int:
    from vacnic_tpu_torch.convert_checkpoint import load_tree
    from vacnic_tpu_torch.core.rng import make_generator, set_random_seed
    from vacnic_tpu_torch.models import bart as B, fusion as F
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.layers import fold_in
    from vacnic_tpu_torch.models.weights_io import tree_to
    from vacnic_tpu_torch.train.loop import fit, generate_captions
    from vacnic_tpu_torch.train.train_step import make_train_step

    dev = _device(args)
    cfg = _build_config(args)
    os.makedirs(args.out_dir, exist_ok=True)
    seed = set_random_seed(cfg.train.seed, cfg.train.prng_impl)

    tokenizer = _bart_tokenizer(args.vocab, args.merges)
    clip_tok = None
    if getattr(args, "clip_vocab", None):
        from vacnic_tpu_torch.data.clip_tokenize import ClipBpeTokenizer

        clip_tok = ClipBpeTokenizer.from_dir(args.clip_vocab)

    params = {
        "model": F.multimodal_bart_init(make_generator(seed, dev), cfg.bart, cfg.fusion,
                                        device=dev),
        # frozen CLIP vision tower for on-the-fly image features (the released
        # config freezes CLIP and never steps its optimizer; train...match.py:376)
        "clip": clip_vision_init(make_generator(fold_in(seed, 3), dev), cfg.clip, device=dev),
    }
    if getattr(args, "clip_ckpt", None):
        params["clip"] = tree_to(_load_clip_vision_ckpt(args.clip_ckpt, cfg.clip), dev)
    if not cfg.train.no_clip_loss:
        # the optional CLIP contrastive loss (train...match.py:312-321;
        # released script disables it) needs the text tower + logit_scale too
        from vacnic_tpu_torch.models.clip_text import clip_text_init

        if getattr(args, "clip_ckpt", None):
            text_tower = tree_to(_load_clip_retrieval_ckpt(args.clip_ckpt, cfg.clip)["text"], dev)
        else:
            text_tower = clip_text_init(make_generator(fold_in(seed, 9), dev), device=dev)
        # drop the integer "heads" leaf: it is no parameter; the count comes
        # from cfg.clip.text_heads
        params["clip_text"] = {k: v for k, v in text_tower.items() if k != "heads"}
    teacher = B.bart_init(make_generator(fold_in(seed, 1), dev), cfg.bart, device=dev)
    if args.init_bart:
        # converted pretrained BART (.npz from convert_checkpoint): seeds
        # shared/encoder/decoder of both the multimodal model and the frozen
        # CoLaM teacher; fusion members keep their fresh init. The model gets
        # copies: its leaves are trained in place, the teacher's never.
        teacher = tree_to(load_tree(args.init_bart), dev)
        pretrained = _detached(teacher, clone=True)
        m = params["model"]
        m["shared"] = pretrained["shared"]
        m["final_logits_bias"] = pretrained["final_logits_bias"]
        for side in ("encoder", "decoder"):
            for k, v in pretrained[side].items():
                if k == "layers":
                    m[side]["layers"] = tuple(
                        {**ours, **theirs} for ours, theirs in zip(m[side]["layers"], v)
                    )
                else:
                    m[side][k] = v
        # NER table re-seeded from the pretrained shared rows (model :1150-1151)
        if "embed_tokens_ner" in m["encoder"]:
            ner_w = m["encoder"]["embed_tokens_ner"]["weight"].clone()
            shared_w = pretrained["shared"]["weight"]
            n = min(ner_w.shape[0], shared_w.shape[0], 50265)
            ner_w[:n] = shared_w[:n]
            m["encoder"]["embed_tokens_ner"] = {"weight": ner_w}
        # Re-apply the attention tie AFTER the pretrained merge: the tie at
        # init captured the random self_attn that the merge just replaced
        # (init_attn_weight_encoder runs on the loaded model, ref :1897-1898).
        if cfg.fusion.init_attn_weight:
            params["model"] = F.tie_fusion_attn_weights(params["model"], cfg.fusion)

    if cfg.train.perturb_bos:
        from vacnic_tpu_torch.train.train_step import perturb_bos

        params["model"] = perturb_bos(params["model"], make_generator(fold_in(seed, 7), dev))

    pattern = {
        "goodnews": "GoodNews/{split}_dict_newsmep_ent_clip{n}sent_contras_name_pos.json",
        "nytimes": "NYTimes/{split}_dict_newsmep_ent_seg_clip{n}sent_contras_name_pos.json",
    }[cfg.data.dataset]
    paths = [
        os.path.join(cfg.data.data_dir, pattern.format(split=s, n=cfg.data.num_sentences))
        for s in ("train", "val", "test")
    ]
    train_loader, val_loader, test_loader = _make_loaders(
        cfg, tokenizer, [(paths[0], True), (paths[1], False), (paths[2], False)],
        clip_tokenizer=clip_tok, device=dev,
    )

    steps_per_epoch = len(train_loader)
    init_fn, step_fn = make_train_step(cfg, cfg.train.num_epochs * steps_per_epoch, device=dev)
    state = init_fn(params, teacher, fold_in(seed, 2))
    if args.resume:
        from vacnic_tpu_torch.train.checkpoints import CheckpointManager

        mgr = CheckpointManager(os.path.join(args.out_dir, "last"))
        state, at = mgr.restore(state)
        print(f"resumed from step {at}", file=sys.stderr)
    state = fit(cfg, state, step_fn, train_loader, val_loader, args.out_dir,
                max_steps=args.max_steps, tokenizer=tokenizer)

    out = generate_captions(
        cfg, state.params, test_loader, tokenizer,
        out_path=os.path.join(args.out_dir, "test_captions.json"), device=dev,
    )
    print(json.dumps({k: out[k] for k in ("bleu", "other metrics") if k in out}))
    return 0


def _init_inference_params(cfg, device):
    """Random-init inference param tree (model + frozen CLIP vision tower) on
    `device` -> (seed, tree): the template for checkpoint restore and serve's
    --random-init mode. The seeds follow cmd_train's (fold_in 3 for the
    tower) so restore templates line up."""
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models import fusion as F
    from vacnic_tpu_torch.models.clip_vit import clip_vision_init
    from vacnic_tpu_torch.models.layers import fold_in

    seed = cfg.decode.seed
    return seed, {
        "model": F.multimodal_bart_init(make_generator(seed, device), cfg.bart, cfg.fusion,
                                        device=device),
        "clip": clip_vision_init(make_generator(fold_in(seed, 3), device), cfg.clip,
                                 device=device),
    }


def _restore_gen_params(ckpt_dir: str, set_overrides, device):
    """Load (cfg, inference params) from a training checkpoint directory:
    the shared restore path of `generate` and `serve`. The params come back
    detached (no leaf requires grad)."""
    from vacnic_tpu_torch.core.rng import make_generator
    from vacnic_tpu_torch.models import bart as B
    from vacnic_tpu_torch.models.layers import fold_in
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager
    from vacnic_tpu_torch.train.train_step import make_train_step

    cfg = CheckpointManager.load_config(ckpt_dir)
    cfg = _apply_overrides(cfg, set_overrides or [])
    seed, params = _init_inference_params(cfg, device)
    teacher = B.bart_init(make_generator(fold_in(seed, 1), device), cfg.bart, device=device)
    init_fn, _ = make_train_step(cfg, 1, device=device)
    template = init_fn(params, teacher, seed)
    del params, teacher
    mgr = CheckpointManager(ckpt_dir)
    try:
        state, step = mgr.restore(template)
        gen_params = state.params
    except Exception:
        # The saved tree can carry what the template cannot predict:
        # params['clip_text'] from a train.no_clip_loss=false run (tower dims
        # from the training-time CLIP checkpoint file), or leaves of another
        # dtype. Inference needs only the params, so fall back to the
        # template-free restore of the saved tree (on the CPU).
        del template
        raw, step = mgr.restore_raw()
        if raw is None:
            raise
        gen_params = raw["params"]
    print(f"restored checkpoint at step {step}", file=sys.stderr)
    return cfg, _detached(gen_params)


def cmd_generate(args) -> int:
    from vacnic_tpu_torch.train.loop import generate_captions

    dev = _device(args)
    cfg, gen_params = _restore_gen_params(args.ckpt_dir, args.set, dev)
    tokenizer = _bart_tokenizer(args.vocab, args.merges)
    mesh = _sharded_decode_mesh(dev, "decode") if args.sharded else None
    (loader,) = _make_loaders(cfg, tokenizer, [(args.data_dict, False)], device=dev)
    out = generate_captions(cfg, gen_params, loader, tokenizer, out_path=args.out, mesh=mesh,
                            device=None if mesh else dev)
    print(json.dumps({k: out[k] for k in ("bleu", "other metrics") if k in out}))
    return 0


def _prune_to_structure(tree, template):
    """Drop dict subtrees absent from `template` (e.g. params['clip_text']
    written by a train.no_clip_loss=false run) so a raw-restored checkpoint
    tree matches the structure the service is already serving; otherwise
    CaptionService.update_params rejects every poll and the watcher serves
    stale weights forever. Raises KeyError when the template needs a
    subtree the checkpoint lacks (an incompatible checkpoint must fail
    loudly, not serve garbage)."""
    if isinstance(template, dict):
        return {k: _prune_to_structure(tree[k], v) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        # a saved list where the served tree holds a tuple (per-layer dicts
        # live in tuples) is coerced to the served container type, so
        # update_params' structure check passes
        if len(tree) != len(template):
            raise ValueError(f"checkpoint sequence length {len(tree)} != "
                             f"served {len(template)}")
        return type(template)(
            _prune_to_structure(t, v) for t, v in zip(tree, template))
    return tree


def _restore_watch_params(ckpt_dir: str, step: int, served_params):
    """Inference-only restore for the checkpoint-watch hot-swap path.

    Unlike _restore_gen_params this does NO device work on the watcher
    thread: no random init, no teacher, no optimizer-state template; just
    the template-free read (CPU tensors) of the requested step, pruned to
    the served tree's structure. The copy to the device happens inside
    CaptionService.update_params, under the service's device lock."""
    from vacnic_tpu_torch.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(ckpt_dir)
    try:
        raw, _ = mgr.restore_raw(step)
    finally:
        mgr.close()
    if raw is None:
        raise RuntimeError(f"no checkpoint at step {step} in {ckpt_dir}")
    return _prune_to_structure(raw["params"], served_params)


def cmd_serve(args) -> int:
    """Online caption serving: micro-batched beam decode behind an HTTP API
    (vacnic_tpu_torch/serve.py). Beyond-reference surface: the reference
    only ships offline batch inference (utils/test_mmbart_clip_ddp.py)."""
    from vacnic_tpu_torch.serve import CaptionService, ServeConfig, http_serve

    dev = _device(args)
    if args.ckpt_dir:
        cfg, params = _restore_gen_params(args.ckpt_dir, args.set, dev)
    elif args.random_init:
        # random-init mode: stand the full serving stack up without a
        # checkpoint (drive tests, load tests, latency rehearsals)
        cfg = _apply_overrides(_preset(args.config), args.set or [])
        _, params = _init_inference_params(cfg, dev)
        print("serving RANDOM-INIT weights (--random-init)", file=sys.stderr)
    else:
        print("serve: need --ckpt-dir or --random-init", file=sys.stderr)
        return 2

    tokenizer = None
    if args.vocab and args.merges:
        tokenizer = _bart_tokenizer(args.vocab, args.merges)

    buckets = tuple(int(b) for b in args.buckets.split(","))
    mesh = None
    if args.sharded:
        mesh = _sharded_decode_mesh(dev, "serving")
        # round buckets up to data-axis multiples so the documented default
        # ladder starts on any device count instead of failing
        # CaptionService's divisibility check
        dp = mesh.shape["data"]
        rounded = tuple(sorted({-(-b // dp) * dp for b in buckets}))
        if rounded != buckets:
            print(f"buckets {list(buckets)} -> {list(rounded)} "
                  f"(rounded up to multiples of the {dp}-way data axis)",
                  file=sys.stderr)
            buckets = rounded
    scfg = ServeConfig(
        buckets=buckets,
        max_wait_ms=args.max_wait_ms,
        input_kind=args.input_kind,
        default_deadline_ms=args.default_deadline_ms,
        fill_to_stable=args.fill_to_stable,
        stable_margin=args.stable_margin,
    )
    service = CaptionService(cfg, params, tokenizer=tokenizer, serve_cfg=scfg,
                             device=None if mesh else dev, mesh=mesh)
    if args.watch_ckpt_s:
        if not args.ckpt_dir:
            print("serve: --watch-ckpt-s needs --ckpt-dir", file=sys.stderr)
            service.close()
            return 2
        from vacnic_tpu_torch.serve import watch_checkpoints
        from vacnic_tpu_torch.train.checkpoints import CheckpointManager

        m = CheckpointManager(args.ckpt_dir)
        initial = m.latest_step()
        m.close()
        watch_checkpoints(
            service, args.ckpt_dir,
            lambda step: _restore_watch_params(args.ckpt_dir, step, service.params),
            poll_s=args.watch_ckpt_s, initial_step=initial)
        print(f"watching {args.ckpt_dir} for new checkpoints every "
              f"{args.watch_ckpt_s:g}s (serving step {initial})", file=sys.stderr)
    if not args.no_precompile:
        print(f"precompiling buckets {scfg.buckets} ...", file=sys.stderr)
        service.precompile()
    try:
        http_serve(service, host=args.host, port=args.port)
    except KeyboardInterrupt:
        pass
    finally:
        service.close()
    return 0


def cmd_evaluate(args) -> int:
    from vacnic_tpu_torch.eval.caption_metrics import compute_caption_metrics
    from vacnic_tpu_torch.eval.entity_eval import evaluate_entity, evaluate_entity_by_gtent
    from vacnic_tpu_torch.eval.face_groups import score_face_groups

    with open(args.results) as f:
        out_dict = json.load(f)
    pairs = [(v["gen"], v["gt"]) for k, v in out_dict.items()
             if k not in ("bleu", "other metrics")]
    report = compute_caption_metrics(pairs)
    if args.gtent:
        with open(args.gtent) as f:
            gtent = json.load(f)
        report["entities"] = evaluate_entity_by_gtent(out_dict, gtent)
    else:
        report["entities"] = evaluate_entity(out_dict)
    if args.data_dict:
        with open(args.data_dict) as f:
            data_dict = json.load(f)
        report["face_groups"] = score_face_groups(out_dict, data_dict)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


def _load_clip_retrieval_ckpt(path: str, vcfg, text_layers: int = 12,
                              text_heads: int = 8) -> dict:
    """Load BOTH CLIP towers for `cli retrieve --clip-ckpt` (reference
    --trained_clip, train...match.py:736-739). Accepts a converted .npz tree
    or a raw .pt: the vision tower goes through the same helper as
    `train --clip-ckpt` (OpenAI or HF format); the text tower only has an
    OpenAI converter. Raises SystemExit when no text tower is available:
    retrieval needs it to score sentences."""
    if path.endswith(".npz"):
        from vacnic_tpu_torch.convert_checkpoint import load_tree

        clip_params = load_tree(path)
    else:
        from vacnic_tpu_torch.models import weights_io as W
        from vacnic_tpu_torch.models.clip_text import convert_clip_text_openai

        sd = W.load_state_dict(path)
        clip_params = {"vision": _load_clip_vision_ckpt(path, vcfg)}
        if any(k.startswith("transformer.resblocks.") for k in sd):
            clip_params["text"] = convert_clip_text_openai(
                sd, layers=text_layers, heads=text_heads)
    if "text" not in clip_params:
        raise SystemExit(
            "clip checkpoint has no text tower usable for retrieval; pass an "
            "OpenAI-format .pt or convert it with "
            "python -m vacnic_tpu_torch.convert_checkpoint clip")
    return clip_params


def cmd_retrieve(args) -> int:
    """CLIP sentence-retrieval preprocessing (the stage ABSENT from the
    reference snapshot, SURVEY §0.1): embed each sample's image, score the
    article's sentences with the CLIP text tower, keep the top
    --num-sentences, and write `sents_byclip` into a copy of the data dict,
    producing the `*_clip{N}sent_contras_name_pos.json` files the trainers
    consume (train...match.py:772, goodnews...py:562-563)."""
    import torch

    from vacnic_tpu_torch.core.config import ClipVisionConfig
    from vacnic_tpu_torch.data.clip_tokenize import ClipBpeTokenizer
    from vacnic_tpu_torch.data.datasets import load_image
    from vacnic_tpu_torch.data.preprocess.clip_retrieval import (retrieve_sentences,
                                                                 split_sentences)
    from vacnic_tpu_torch.models.clip_vit import clip_image_embed
    from vacnic_tpu_torch.models.weights_io import tree_to

    dev = _device(args)
    vcfg = ClipVisionConfig()
    clip_params = tree_to(_load_clip_retrieval_ckpt(args.clip_ckpt, vcfg), dev)
    tok = ClipBpeTokenizer.from_dir(args.clip_vocab)

    with open(args.data_dict) as f:
        data_dict = json.load(f)
    n_done = 0
    for hash_id, rec in data_dict.items():
        art_path = os.path.join(args.data_base_dir, "articles_full", f"{hash_id}.txt")
        if "article" in rec:
            article = rec["article"]
        elif os.path.exists(art_path):
            with open(art_path) as f:
                article = f.read()
        else:
            continue
        img_path = os.path.join(args.data_base_dir, "images_processed", f"{hash_id}.jpg")
        if not os.path.exists(img_path):
            continue
        with torch.no_grad():
            img_embed = clip_image_embed(clip_params["vision"], load_image(img_path)[None],
                                         vcfg)[0]
        if len(split_sentences(article)) > 1:
            rec["sents_byclip"] = retrieve_sentences(
                clip_params["text"], tok, img_embed, article,
                num_sentences=args.num_sentences)
        else:
            rec["sents_byclip"] = article
        n_done += 1
    with open(args.out, "w") as f:
        json.dump(data_dict, f)
    print(f"retrieved top-{args.num_sentences} sentences for {n_done} samples → {args.out}")
    return 0


def cmd_lmm(args) -> int:
    """LMM zero-shot prompting over a split (test_*_prompt.py equivalents)."""
    from vacnic_tpu_torch.data.datasets import NewsCaptionDataset
    from vacnic_tpu_torch.eval.caption_metrics import compute_caption_metrics
    from vacnic_tpu_torch.lmm import prompting as P

    if args.backend == "echo":
        backend = P.EchoBackend()
    else:
        cls = {"instructblip": P.InstructBlipBackend, "llava": P.LlavaBackend}[args.backend]
        backend = cls(device=_device(args))
    with open(args.data_dict) as f:
        data_dict = json.load(f)
    ds = NewsCaptionDataset(
        data_dict, args.data_base_dir, tokenizer=None, dataset=args.dataset,
        retrieved_sent=args.use_retrieval, raw_mode=True,
    )

    def loader():
        bs = args.batch_size
        for i in range(0, len(ds), bs):
            samples = [ds[j] for j in range(i, min(i + bs, len(ds)))]
            yield {
                "article": [s["article"] for s in samples],
                "caption": [s["caption"] for s in samples],
                "raw_img": [s["raw_img"] for s in samples],
            }

    out = P.prompt_captions(backend, loader(), use_retrieval=args.use_retrieval,
                            out_path=args.out)
    flat = P.flatten_for_scoring(out)
    m = compute_caption_metrics([(v["gen"], v["gt"]) for v in flat.values()])
    print(json.dumps(m))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vacnic_tpu_torch")
    device_help = ('device of every tensor: "cuda" (default) or "cpu"; without a card '
                   'a "cuda" run exits instead of falling back')
    p.add_argument("--device", default="cuda", help=device_help)
    # the same flag after the subcommand; absent there, the one above holds
    device_flag = argparse.ArgumentParser(add_help=False)
    device_flag.add_argument("--device", default=argparse.SUPPRESS, help=device_help)
    sub = p.add_subparsers(dest="cmd", required=True)

    def add(name: str, **kw):
        return sub.add_parser(name, parents=[device_flag], **kw)

    sp = add("train", help="train the multimodal captioner")
    sp.add_argument("--config", choices=["full", "onlyvis", "tiny"], default="full")
    sp.add_argument("--data-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.add_argument("--vocab", required=True, help="BART vocab.json")
    sp.add_argument("--merges", required=True, help="BART merges.txt")
    sp.add_argument("--max-steps", type=int, default=None)
    sp.add_argument("--init-bart", default=None,
                    help="converted BART .npz (vacnic_tpu_torch.convert_checkpoint) to init from")
    sp.add_argument("--resume", action="store_true",
                    help="resume from <out-dir>/last (full TrainState incl. optimizer)")
    sp.add_argument("--set", action="append", metavar="sec.field=val")
    sp.add_argument("--clip-ckpt", default=None,
                    help="stock or fine-tuned CLIP vision checkpoint "
                         "(.npz tree or OpenAI/HF .pt — reference "
                         "--trained_clip, train...match.py:736-739)")
    sp.add_argument("--clip-vocab", default=None,
                    help="CLIP BPE vocab (bpe_simple_vocab_16e6.txt.gz or HF dir) "
                         "→ emit caption_ids_clip for the CLIP contrastive loss")
    sp.set_defaults(fn=cmd_train)

    sp = add("generate", help="beam-decode a split from a checkpoint")
    sp.add_argument("--ckpt-dir", required=True)
    sp.add_argument("--data-dict", required=True)
    sp.add_argument("--vocab", required=True)
    sp.add_argument("--merges", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--set", action="append")
    sp.add_argument("--sharded", action="store_true",
                    help="shard the beam search over all visible devices")
    sp.set_defaults(fn=cmd_generate)

    sp = add("serve", help="online caption service (micro-batched HTTP)")
    sp.add_argument("--ckpt-dir", default=None)
    sp.add_argument("--random-init", action="store_true",
                    help="serve random-init weights (drive/load testing)")
    sp.add_argument("--config", choices=["full", "onlyvis", "tiny"], default="full",
                    help="config preset for --random-init (ckpt runs use the saved config)")
    sp.add_argument("--vocab", default=None, help="BART vocab.json (else token-id output)")
    sp.add_argument("--merges", default=None)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8500)
    sp.add_argument("--buckets", default="1,8,32,64",
                    help="comma-separated static batch buckets (each a batch "
                         "shape the service warms and pads to)")
    sp.add_argument("--max-wait-ms", type=float, default=10.0,
                    help="batcher hold time for incomplete batches (latency/throughput dial)")
    sp.add_argument("--input-kind", choices=["image_cls", "pixels"], default="image_cls")
    sp.add_argument("--watch-ckpt-s", type=float, default=None,
                    help="poll --ckpt-dir every N seconds and hot-swap newer "
                         "checkpoints into the running service")
    sp.add_argument("--default-deadline-ms", type=float, default=None,
                    help="shed requests older than this at batch-form time "
                         "(504 over HTTP); per-request deadline_ms overrides")
    sp.add_argument("--no-precompile", action="store_true")
    sp.add_argument("--fill-to-stable", action="store_true",
                    help="additionally WAIT (stability-bounded) to fill the "
                         "stable-target bucket; the no-wait saturation-aware "
                         "defer is always on (serve.py)")
    sp.add_argument("--stable-margin", type=float, default=1.5,
                    help="stability headroom: a bucket is escalation-exempt "
                         "only if its measured capacity covers "
                         "arrival_rate * margin")
    sp.add_argument("--sharded", action="store_true",
                    help="data-parallel serving over all visible devices")
    sp.add_argument("--set", action="append", metavar="sec.field=val")
    sp.set_defaults(fn=cmd_serve)

    sp = add("retrieve", help="CLIP sentence-retrieval preprocessing")
    sp.add_argument("--data-dict", required=True)
    sp.add_argument("--data-base-dir", required=True)
    sp.add_argument("--clip-ckpt", required=True,
                    help="converted CLIP .npz (vacnic_tpu_torch.convert_checkpoint clip)")
    sp.add_argument("--clip-vocab", required=True)
    sp.add_argument("--num-sentences", type=int, default=8)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_retrieve)

    sp = add("evaluate", help="score a caption-results JSON")
    sp.add_argument("--results", required=True)
    sp.add_argument("--gtent", default=None)
    sp.add_argument("--data-dict", default=None)
    sp.add_argument("--out", default=None)
    sp.set_defaults(fn=cmd_evaluate)

    sp = add("lmm", help="LMM zero-shot prompting baseline")
    sp.add_argument("--backend", choices=["echo", "instructblip", "llava"], default="echo")
    sp.add_argument("--data-dict", required=True)
    sp.add_argument("--data-base-dir", required=True)
    sp.add_argument("--dataset", choices=["goodnews", "nytimes"], default="goodnews")
    sp.add_argument("--use-retrieval", action="store_true")
    sp.add_argument("--batch-size", type=int, default=4)
    sp.add_argument("--out", required=True)
    sp.set_defaults(fn=cmd_lmm)

    sp = add("smoke", help="small synthetic end-to-end self-check")
    sp.set_defaults(fn=cmd_smoke)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
