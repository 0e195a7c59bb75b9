"""The port's data layer (vacnic_tpu_torch/data/preprocess/entity_ids.py,
data/collate.py, data/datasets.py, data/pipeline.py) against the JAX
package's, on an on-disk GoodNews-layout fixture and BPE vocab each test
writes itself (chip_smoke.py's writers, the data phase's):

* entity ids and collate identical, array for array, dtypes included;
* NewsCaptionDataset samples identical to JAX's, pixels included (the same
  Pillow decode, resize and normalisation): GoodNews and NYTimes key
  spellings, retrieval on and off, rows without faces, a row whose NER mask
  is missing, the CLIP caption ids, `raw_mode`, and the training flip;
* PrefetchLoader(device="cpu") batches equal to the JAX loader's arrays for
  the same seed over two epochs, with both `drop_last` values. With
  train=True the horizontal flip draws from one RandomState shared by the
  worker threads (vacnic_tpu/data/datasets.py:110, :141), so its order is
  not deterministic for num_workers > 1, in JAX either: that case runs with
  num_workers=1;
* the abandoned-iterator and producer-error cases, and the refusals
  (`sharding=` beside a device, the default device without a card; the
  sharded batches themselves: tests/test_torch_mesh.py).

Tolerance: none; every comparison is exact."""

import runpy
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from vacnic_tpu.data import collate as JCo
from vacnic_tpu.data import datasets as JD
from vacnic_tpu.data.clip_tokenize import ClipBpeTokenizer as JClip
from vacnic_tpu.data.pipeline import PrefetchLoader as JLoader
from vacnic_tpu.data.preprocess import entity_ids as JE
from vacnic_tpu.data.tokenize import BartBpeTokenizer as JBpe
from vacnic_tpu.data.tokenize import HashWordTokenizer as JHash
from vacnic_tpu_torch.data import collate as TCo
from vacnic_tpu_torch.data import datasets as TD
from vacnic_tpu_torch.data.clip_tokenize import ClipBpeTokenizer as TClip
from vacnic_tpu_torch.core.config import MeshConfig
from vacnic_tpu_torch.core.mesh import make_mesh
from vacnic_tpu_torch.data.pipeline import THREAD_NAME, PrefetchLoader, shard_for_data_parallel
from vacnic_tpu_torch.data.preprocess import entity_ids as TE
from vacnic_tpu_torch.data.tokenize import BartBpeTokenizer as TBpe
from vacnic_tpu_torch.data.tokenize import HashWordTokenizer as THash

REPO = Path(__file__).resolve().parents[1]
SMOKE = runpy.run_path(str(REPO / "chip_smoke.py"), run_name="chip_smoke_helpers")
SPECIAL = list(SMOKE["SPECIAL_TOKENS"])
SPLITS = (("train", 6), ("test", 5))
BUCKETS = dict(article_len=64, caption_len=24, ner_len=12, ner_len_gt=6, max_faces=2,
               face_dim=8, num_names=3, name_len=6)


def same(got, want, where=""):
    """Exact equality of port output against JAX output: tensors and arrays
    by dtype, shape and value; dicts, lists, PIL images recursively."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            same(got[k], want[k], f"{where}.{k}")
    elif isinstance(got, torch.Tensor) or isinstance(want, np.ndarray) or hasattr(want, "dtype"):
        g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
        w = np.asarray(want)
        assert g.dtype == w.dtype and g.shape == w.shape, (where, g.dtype, w.dtype, g.shape)
        np.testing.assert_array_equal(g, w, err_msg=where)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            same(a, b, f"{where}[{i}]")
    elif hasattr(want, "tobytes"):  # a PIL image
        assert got.size == want.size and got.mode == want.mode and got.tobytes() == want.tobytes()
    else:
        assert got == want, (where, got, want)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    root = tmp_path_factory.mktemp("news")
    vocab = SMOKE["write_bpe_vocab"](str(root), size=None)
    base, dicts = SMOKE["write_news_fixture"](str(root), splits=SPLITS, image_size=40,
                                              face_dim=8, article_words=60)
    (Path(base) / "articles_full_newsmep_ent_by_count" / "train001.json").unlink()  # no NER mask
    for gn, nyt in (("articles_full", "articles_seg"),  # the NYTimes layout's directory names
                    ("articles_full_newsmep_ent_by_count", "articles_seg_newsmep_ent_by_count")):
        (Path(base) / nyt).symlink_to(Path(base) / gn)
    return base, dicts, vocab


@pytest.fixture(scope="module")
def toks(fixture):
    j, t = JBpe(*fixture[2]), TBpe(*fixture[2])
    for tok in (j, t):
        tok.add_special_tokens(SPECIAL)
    return j, t


# -- entity ids, collate ----------------------------------------------------------

def test_entity_ids_match_jax(toks):
    jt, tt = toks
    jh, th = JHash(50265), THash(50265)
    for tok in (jh, th):
        tok.add_special_tokens(SPECIAL)
    assert TE.find_first_sublist([1, 2, 3, 4, 3, 4], [3, 4], 3) == JE.find_first_sublist(
        [1, 2, 3, 4, 3, 4], [3, 4], 3) == (4, 6)
    assert TE.find_first_sublist([1], []) is JE.find_first_sublist([1], []) is None
    for ents in (["Barack Obama", "Obama", "Biden"], ["John Smith", "John Smith"], ["", "A"]):
        assert TE.dedupe_entities(ents) == JE.dedupe_entities(ents)
    cases = [("Alice Smith met Bob Jones in Paris", ["Alice Smith", "Bob Jones", "Paris"], 12),
             ("Alice Smith met Bob", ["Alice Smith", "Bob"], 20),
             ("nothing here", [], 10),
             ("text", [f"Entity{i} Name{i}" for i in range(30)], 12)]
    for (jtok, ttok) in ((jt, tt), (jh, th)):
        for text, ents, n in cases:
            assert TE.make_entity_ids(text, ents, ttok, max_length=n) == JE.make_entity_ids(
                text, ents, jtok, max_length=n)
    ids = [5, 50267, 50267, 6, 50267, 7] + [50267] * 4
    for tgt in (False, True):
        for cap in (512, 7):
            assert TE.person_token_positions(ids, 50267, cap, tgt) == JE.person_token_positions(
                ids, 50267, cap, tgt)


def samples(n=5, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        out.append({
            "article_ids": rng.randint(0, 500, rng.randint(3, 90)).tolist(),
            "caption_ids": rng.randint(0, 500, rng.randint(2, 30)).tolist(),
            "names_art_ids": [0, 11, 12, 2], "names_ids_flatten": [0, 13, 2],
            "org_norp_gpe_loc_art_ids": [0, 14, 2], "org_norp_gpe_loc_ids_flatten": [0, 2],
            "all_gt_ner_ids": rng.randint(0, 500, 15).tolist(),
            "names_ids": [[0, 14, 15, 2]] * (i % 4) + [[0, 50266, 2]],
            "face_emb": rng.randn(i % 3, 8).astype(np.float32),
            "obj_emb": rng.randn(i % 2, 16).astype(np.float32),
            "caption": f"caption {i}",
            "pixels": rng.randn(8, 8, 3).astype(np.float32),
            "article_ner_mask_ids": rng.randint(0, 500, 40).tolist(),
            "caption_ids_clip": rng.randint(1, 400, rng.randint(2, 80)).tolist(),
            "person_id_positions": [[1, 2]] * (i % 2),
            "sample_idx": 10 + i,
        })
    return out


@pytest.mark.parametrize("objects", [0, 3])
def test_collate_matches_jax(objects):
    s = samples()
    kw = dict(BUCKETS, max_objects=objects, obj_dim=16, clip_len=77, noname_id=50266)
    got, want = TCo.collate(s, **kw), JCo.collate(s, **kw)
    same(got, want)
    assert got["article_ids"].dtype == np.int32 and got["face_emb"].dtype == np.float32
    np.testing.assert_array_equal(got["face_emb"][0], np.ones((2, 8), np.float32))
    minimal = [{k: v for k, v in x.items() if k in ("article_ids", "caption_ids", "names_art_ids",
                                                     "names_ids_flatten")} for x in s]
    same(TCo.collate(minimal, **BUCKETS), JCo.collate(minimal, **BUCKETS))
    rows = [[[0, 5, 6, 7, 8, 9, 2]], []]
    same(TCo.pad_names_3d(rows, 2, 4), JCo.pad_names_3d(rows, 2, 4))
    same(TCo.pad_ids([[1, 2, 3], []], 2, pad=0), JCo.pad_ids([[1, 2, 3], []], 2, pad=0))
    feats = [np.zeros((0, 4)), np.arange(12.0).reshape(3, 4), np.ones(4)]
    same(TCo.pad_feats(feats, 2, 4), JCo.pad_feats(feats, 2, 4))
    assert TCo.NONAME_ID == JCo.NONAME_ID


# -- NewsCaptionDataset -----------------------------------------------------------

def datasets(fixture, toks, split="train", nytimes=False, **kw):
    base, dicts, _ = fixture
    dd = dicts[split]
    if nytimes:  # the NYTimes spellings of the entity keys (nytimes...py:636-641)
        dd = {h: {{"names": "name_cap", "org_norp": "org_norp_cap", "gpe_loc": "gpe_loc_cap",
                   "names_art": "name_art"}.get(k, k): v for k, v in r.items()}
              for h, r in dd.items()}
    kw = dict(dict(max_article_len=48, max_caption_len=20, max_ner_type_len=12,
                   max_ner_type_len_gt=6, image_size=32), **kw)
    name = "nytimes" if nytimes else "goodnews"
    return (TD.NewsCaptionDataset(dd, base, toks[1], name, **kw),
            JD.NewsCaptionDataset(dd, base, toks[0], name, **kw))


@pytest.mark.parametrize("nytimes", [False, True], ids=["goodnews", "nytimes"])
@pytest.mark.parametrize("retrieved", [True, False], ids=["retrieved", "full_article"])
def test_dataset_samples_match_jax(fixture, toks, nytimes, retrieved):
    t, j = datasets(fixture, toks, nytimes=nytimes, retrieved_sent=retrieved)
    assert len(t) == len(j) == 6
    for i in range(len(t)):
        same(t[i], j[i], f"row {i}")
    s0, s1 = t[0], t[1]
    assert s0["pixels"].shape == (32, 32, 3) and s0["pixels"].dtype == np.float32
    assert s0["face_emb"].shape[1] == 8 and s1["face_emb"].shape == (0, 512)  # no faces
    assert s0["person_id_positions"] == [[2, 3], [6, 6]]
    assert s1["person_id_positions"] == []  # its NER mask file is missing
    assert s0["caption"].isascii() or nytimes  # GoodNews captions are ascii-folded


def test_dataset_train_flip_and_clip_ids_match_jax(fixture, toks, tmp_path):
    gz = tmp_path / "clip.txt.gz"
    import gzip

    with gzip.open(gz, "wt", encoding="utf-8") as f:
        f.write("header\nh e\nl o</w>\nhe l\nhel lo</w>\np h\nph o\npho t\nphot o</w>")
    for seed in (0, 3):
        t, j = datasets(fixture, toks, train=True, seed=seed, image_size=40,
                        clip_tokenizer=None)
        t.clip_tokenizer = TClip.from_openai_vocab(str(gz))
        j.clip_tokenizer = JClip.from_openai_vocab(str(gz))
        got = [t[i] for i in range(len(t))]
        want = [j[i] for i in range(len(j))]
        same(got, want)
        assert all(len(s["caption_ids_clip"]) <= 77 for s in got)


def test_dataset_raw_mode_and_helpers_match_jax(fixture, toks):
    for retrieved in (True, False):
        t, j = datasets(fixture, toks, "test", raw_mode=True, retrieved_sent=retrieved)
        for i in range(len(t)):
            same(t[i], j[i])
    for text in ("Alice Smith — café naïve Ünïcödé", "plain", "東京"):
        assert TD.ascii_fold(text) == JD.ascii_fold(text)
    same(TD.CLIP_MEAN, JD.CLIP_MEAN)
    same(TD.CLIP_STD, JD.CLIP_STD)
    path = str(Path(fixture[0]) / "images_processed" / "test000.jpg")
    for size in (40, 24):
        same(TD.load_image(path, size), JD.load_image(path, size))


# -- PrefetchLoader ---------------------------------------------------------------

def loaders(fixture, toks, split, train, drop_last, workers, seed=5, bs=2):
    t, j = datasets(fixture, toks, split, train=train)
    tl = PrefetchLoader(t, bs, lambda s: TCo.collate(s, **BUCKETS), seed=seed,
                        num_workers=workers, drop_last=drop_last, device="cpu")
    jl = JLoader(j, bs, lambda s: JCo.collate(s, **BUCKETS), seed=seed, num_workers=workers,
                 drop_last=drop_last)
    return tl, jl


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("train,workers", [(False, 3), (True, 1)], ids=["eval", "train_flip"])
def test_loader_batches_match_jax(fixture, toks, drop_last, train, workers):
    tl, jl = loaders(fixture, toks, "test", train, drop_last, workers)
    assert len(tl) == len(jl) == (2 if drop_last else 3)
    for epoch in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for b, (g, w) in enumerate(zip(got, want)):
            same(g, {k: np.asarray(v) if not isinstance(v, list) else v for k, v in w.items()},
                 f"epoch {epoch + 1} batch {b}")
            assert all(v.device.type == "cpu" for v in g.values() if isinstance(v, torch.Tensor))
    assert got[-1]["sample_idx"].shape[0] == (2 if drop_last else 1)


class Toy:
    def __init__(self, n=64, bad=None):
        self.n, self.bad = n, bad

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.bad:
            raise OSError("corrupt image file")
        return samples(1, seed=int(i))[0]


def toy_collate(s):
    return TCo.collate(s, **BUCKETS)


def producer_threads():
    return [t for t in threading.enumerate() if t.name.startswith(THREAD_NAME) and t.is_alive()]


def test_abandoned_iterator_leaves_no_thread():
    loader = PrefetchLoader(Toy(), 4, toy_collate, num_workers=2, prefetch=1, device="cpu")
    it = iter(loader)
    next(it)  # the producer runs ahead and blocks on the size-1 queue
    it.close()
    deadline = time.time() + 10.0
    while producer_threads() and time.time() < deadline:
        time.sleep(0.05)
    assert not producer_threads()


def test_shared_tokenizer_under_thread_stress(fixture):
    """One fresh tokenizer shared by more threads than cores, with a short
    switch interval: the merge engine is set up once and every encode
    equals the serial one's."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    texts = [r[k] for d in fixture[1].values() for r in d.values()
             for k in ("sents_byclip", "caption")] * 4
    serial = TBpe(*fixture[2])
    want = [serial.encode(t) for t in texts]
    shared = TBpe(*fixture[2])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(32) as pool:
            got = list(pool.map(shared.encode, texts))
    finally:
        sys.setswitchinterval(interval)
    assert got == want and shared.engine == serial.engine


def test_producer_error_surfaces():
    loader = PrefetchLoader(Toy(8, bad=5), 4, toy_collate, num_workers=2, shuffle=False,
                            device="cpu")
    with pytest.raises(OSError, match="corrupt image file"):
        list(loader)


def test_loader_refusals():
    mesh = make_mesh(MeshConfig(), devices=["cpu"] * 2)
    with pytest.raises(ValueError, match="sharding= or device="):  # the mesh names the devices
        PrefetchLoader(Toy(), 4, toy_collate, sharding=shard_for_data_parallel(mesh),
                       device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            PrefetchLoader(Toy(), 4, toy_collate)  # the card by default, no fallback
    loader = PrefetchLoader(Toy(9), 4, toy_collate, shuffle=False, drop_last=False,
                            device_keys=("article_ids",), device="cpu")
    b = next(iter(loader))
    assert isinstance(b["article_ids"], torch.Tensor) and isinstance(b["face_emb"], np.ndarray)
    assert len(loader) == 3 and loader.pinned_bytes == 0
