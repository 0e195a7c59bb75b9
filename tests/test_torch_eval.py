"""The port's evaluation layer (vacnic_tpu_torch/eval/) against the JAX
package's on a seeded corpus of caption pairs: BLEU-1..4, ROUGE-L, CIDEr-D,
METEOR-1.5 (segment statistics, sentence and corpus scores),
`compute_caption_metrics` (keys and `meteor_scorer` provenance, with and
without VACNIC_METEOR_DEBUG=1), HeuristicNER, `evaluate_entity`,
`evaluate_entity_by_gtent`, `split_by_face_group` and `score_face_groups`;
the jar driver's line protocol against a stub; and the port's own Porter
stemmer (eval/porter.py, which METEOR's stem stage uses in place of nltk's)
equal to nltk's default PorterStemmer over a word list.

Tolerance: scores within 1e-12 (the same float operations in the same
order give them bit for bit; the bound only guards the comparison), counts,
strings and dict keys exact."""

import glob
import random
import re
import string
import sys
import textwrap
from pathlib import Path

import pytest

from vacnic_tpu.eval import caption_metrics as JM
from vacnic_tpu.eval import entity_eval as JE
from vacnic_tpu.eval import face_groups as JF
from vacnic_tpu.eval import meteor15 as J15
from vacnic_tpu.eval import meteor_py as JPy
from vacnic_tpu_torch.eval import caption_metrics as TM
from vacnic_tpu_torch.eval import entity_eval as TE
from vacnic_tpu_torch.eval import face_groups as TF
from vacnic_tpu_torch.eval import meteor15 as T15
from vacnic_tpu_torch.eval import meteor_py as TPy
from vacnic_tpu_torch.eval import porter

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-12
WORDS = ("the a of in and to on at with for press photo shows waving crowd gathered today "
         "city council meeting president minister visits visited visiting speech during after "
         "team games season police officers street protest protesters market school students "
         "family river bridge festival music nights morning week year new old").split()
NAMES = ["Barack Obama", "Angela Merkel", "Alice Smith", "Paris", "London", "World Bank Group",
         "United Nations", "July 2009", "March 3, 2020", "New York Times", "Sony Corp"]


def corpus(n=40, seed=0):
    """(generated, ground truth) pairs sharing words, names and punctuation."""
    rng = random.Random(seed)

    def caption():
        ws = rng.choices(WORDS, k=rng.randint(0 if rng.random() < 0.05 else 3, 18))
        for _ in range(rng.randint(0, 3)):
            ws.insert(rng.randint(0, len(ws)), rng.choice(NAMES))
        s = " ".join(ws)
        return (s[:1].upper() + s[1:] + rng.choice(["", ".", "!", ", today."])).strip()

    pairs = []
    for _ in range(n):
        gt = caption()
        gen = gt if rng.random() < 0.15 else caption()
        if rng.random() < 0.3:  # a near copy
            w = gt.split()
            rng.shuffle(w[: len(w) // 2])
            gen = " ".join(w)
        pairs.append((gen, gt))
    return pairs


def close(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for a, b in zip(got, want):
            close(a, b, where)
    elif isinstance(want, float):
        assert isinstance(got, float) and abs(got - want) <= TOL, (where, got, want)
    else:
        assert got == want, (where, got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_scorers_match_jax(seed):
    pairs = corpus(seed=seed)
    for n in (1, 2, 4):
        tb, jb = TM.BleuScorer(n), JM.BleuScorer(n)
        tc, jc = TM.CiderScorer(n, 6.0), JM.CiderScorer(n, 6.0)
        for gen, gt in pairs:
            refs = [gt, gt.lower()] if n == 2 else [gt]
            for s in (tb, jb, tc, jc):
                s.append(gen, refs)
        close(tb.compute(), jb.compute())
        close(tc.compute(), jc.compute())
    for gen, gt in pairs:
        assert TM.score_tokenize(gen) == JM.score_tokenize(gen)
        close(TM.rouge_l(gen, [gt]), JM.rouge_l(gen, [gt]))
        close(TM.rouge_l(gen, [gt, gen[: len(gen) // 2]], beta=2.0),
              JM.rouge_l(gen, [gt, gen[: len(gen) // 2]], beta=2.0))
    assert TM.CiderScorer().compute() == JM.CiderScorer().compute() == 0.0


@pytest.mark.parametrize("seed", [0, 2])
def test_meteor15_matches_jax(seed):
    pairs = corpus(30, seed=seed)
    for gen, gt in pairs[:12]:
        t, j = T15.SegmentStats(gen, gt), J15.SegmentStats(gen, gt)
        assert [getattr(t, k) for k in t.__slots__] == [getattr(j, k) for k in j.__slots__]
        close(T15.meteor15_sentence(gen, [gt, "the crowd"]),
              J15.meteor15_sentence(gen, [gt, "the crowd"]))
    hyps, refs = [g for g, _ in pairs], [[r] for _, r in pairs]
    close(T15.meteor15_corpus(hyps, refs), J15.meteor15_corpus(hyps, refs))
    assert T15.meteor15_corpus([], []) == J15.meteor15_corpus([], []) == 0.0
    close(TPy.meteor_corpus(pairs), JPy.meteor_corpus(pairs))
    assert T15.FUNCTION_WORDS == J15.FUNCTION_WORDS
    assert T15.find_meteor_jar() == J15.find_meteor_jar()


@pytest.mark.parametrize("debug", [False, True])
def test_compute_caption_metrics_matches_jax(debug, monkeypatch):
    if debug:
        monkeypatch.setenv("VACNIC_METEOR_DEBUG", "1")
    for pairs in (corpus(40, seed=3), [("A man, walking!", "A man walking.")],
                  [("", "something"), ("x", "")]):
        got, want = TM.compute_caption_metrics(pairs), JM.compute_caption_metrics(pairs)
        close(got, want)
        assert got["other metrics"]["meteor_scorer"] == "meteor15_py(exact+stem)"
        assert ("meteor_py_debug" in got["other metrics"]) == debug
    close(TM.compute_caption_metrics([]), JM.compute_caption_metrics([]))


def gtent_dict(pairs):
    ner = JE.HeuristicNER()
    out = {}
    for i, (_, gt) in enumerate(pairs):
        ents, _ = ner(gt)
        out[f"h{i}"] = {"ner_cap": [e["text"] for e in ents],
                        "names_cap": [e["text"] for e in ents if e["label"] == "PERSON"],
                        "org_cap": [e["text"] for e in ents if e["label"] == "ORG"][:1],
                        "gpe_cap": ["paris"] if i % 3 == 0 else []}
    return out


def test_entity_eval_matches_jax():
    pairs = corpus(40, seed=4)
    out = {i: {"gt": gt, "gen": gen} for i, (gen, gt) in enumerate(pairs)}
    out.update(JM.compute_caption_metrics(pairs[:3]))  # metric rows are skipped
    for lower in (True, False):
        tn, jn = TE.HeuristicNER(lowercase=lower), JE.HeuristicNER(lowercase=lower)
        for _, gt in pairs:
            assert tn(gt) == jn(gt)
    got = TE.evaluate_entity(out, TE.HeuristicNER())
    assert got == JE.evaluate_entity(out, JE.HeuristicNER())
    assert got["ner_engine"] == "heuristic" and got["Entity all - recall"]["total"] > 0
    gt = gtent_dict(pairs)
    assert (TE.evaluate_entity_by_gtent(out, gt, TE.HeuristicNER())
            == JE.evaluate_entity_by_gtent(out, gt, JE.HeuristicNER()))
    with pytest.raises(ValueError, match="positional alignment"):
        TE.evaluate_entity_by_gtent(out, dict(list(gt.items())[:-1]), TE.HeuristicNER())
    assert type(TE.default_ner()).__name__ == type(JE.default_ner()).__name__


def test_face_groups_match_jax():
    pairs = corpus(24, seed=5)
    out = {i: {"gt": gt, "gen": gen} for i, (gen, gt) in enumerate(pairs)}
    out["bleu"], out["other metrics"] = {}, {}
    data = {}
    for i in range(24):
        rec = {"face_emb_dir": f"faces/{i}.npy" if i % 2 else ([] if i % 4 else "")}
        rec["names" if i % 3 else "name_cap"] = ["N"] if i % 5 else []
        data[f"h{i}"] = rec
    groups = TF.split_by_face_group(out, data)
    assert groups == JF.split_by_face_group(out, data)
    assert all(groups.values())
    for ents in (False, True):
        close(TF.score_face_groups(out, data, TE.HeuristicNER(), with_entities=ents),
              JF.score_face_groups(out, data, JE.HeuristicNER(), with_entities=ents))
    with pytest.raises(ValueError, match="positional alignment"):
        TF.split_by_face_group(out, dict(list(data.items())[:-1]))


def test_jar_driver_protocol(tmp_path):
    """JarMeteor against a stub speaking the jar's -stdio protocol: the port
    writes the lines JAX's driver writes and reads the same scores."""
    stub = tmp_path / "stub.py"
    stub.write_text(textwrap.dedent("""
        import sys
        log = open(sys.argv[1], "a")
        n = 0
        for line in sys.stdin:
            log.write(line); log.flush()
            if line.startswith("SCORE"):
                n += 1
                print("1 2 3"); sys.stdout.flush()
            elif line.startswith("EVAL"):
                for i in range(n):
                    print(0.25 * (i + 1)); sys.stdout.flush()
                print(0.5); sys.stdout.flush()
    """))
    results = {}
    for name, mod in (("port", T15), ("jax", J15)):
        log = tmp_path / f"{name}.txt"
        jar = mod.JarMeteor(cmd=[sys.executable, str(stub), str(log)])
        try:
            results[name] = jar.compute_score(["hyp one", "hyp ||| two"],
                                              [["ref a"], ["ref b", "ref c"]])
        finally:
            jar.close()
        results[name + "_lines"] = log.read_text().splitlines()
    assert results["port"] == results["jax"] == (0.5, [0.25, 0.5])
    assert results["port_lines"] == results["jax_lines"]
    assert results["port_lines"][1] == "SCORE ||| ref b ||| ref c ||| hyp two"


def test_porter_matches_nltk():
    PorterStemmer = pytest.importorskip("nltk.stem.porter").PorterStemmer
    ps = PorterStemmer()
    words = set(porter.POOL)
    for f in glob.glob(str(REPO / "*.md")):  # the repo's own English prose
        words.update(re.findall(r"[A-Za-z]+", Path(f).read_text(errors="ignore")))
    suffixes = ("ational tional enci anci izer bli alli entli eli ousli ization ation ator "
                "alism iveness fulness ousness aliti iviti biliti fulli logi icate ative alize "
                "iciti ical ful ness al ance ence er ic able ible ant ement ment ent ion sion tion "
                "ou ism ate iti ous ive ize e ll s sses ies ss ed ing eed ied y ying ly ally").split()
    rng = random.Random(0)
    for _ in range(8000):
        w = "".join(rng.choice(string.ascii_lowercase + "aeiouy" * 2)
                    for _ in range(rng.randint(1, 8)))
        words.update((w, w + rng.choice(suffixes), w.upper()))
    bad = [(w, ps.stem(w), porter.stem(w)) for w in sorted(words) if ps.stem(w) != porter.stem(w)]
    assert not bad, bad[:10]
    assert len(words) > 20000
