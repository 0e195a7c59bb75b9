"""What every run does, whatever the cell: find the cell's files by name,
build the port's configuration, call the cell's driver, pick the metrics
the manifest asks of the cell, read the per-layer ones through their
readers, and print the result line."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any

import torch

HERE = os.path.dirname(os.path.abspath(__file__))


class Refused(Exception):
    """The run cannot measure: no result is printed and the exit code is 2."""


# ---------------------------------------------------------------------------
# files by name
# ---------------------------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused(f"no BENCHMARK.json in {root}")
    return load_json(path)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"no cell {name!r} in BENCHMARK.json")


def require_cards(n: int) -> None:
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the port on the card only")
    if torch.cuda.device_count() < n:
        raise Refused(f"the cell asks for {n} cards, {torch.cuda.device_count()} present")


def load_module(path: str, name: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_spec(name: str) -> dict:
    return load_json(os.path.join(HERE, "workloads", f"{name}.json"))


def config_file(name: str) -> dict:
    return load_json(os.path.join(HERE, "configs", f"{name}.json"))


def driver_module(name: str):
    return load_module(os.path.join(HERE, "drivers", f"{name}.py"), f"portbench_driver_{name}")


def metric_reader(name: str):
    return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                       "portbench_metric_" + name.replace(".", "_"))


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    reported = {m["name"] for m in end_to_end_for(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in reported)]


# ---------------------------------------------------------------------------
# what a driver gets and gives
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Context:
    name: str
    spec: dict      # portbench/workloads/<cell>.json
    config: dict    # portbench/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: str
    t_start: float  # the process's start on perf_counter's clock

    @property
    def sizes(self) -> dict:
        return self.config["sizes"]

    def port_config(self):
        """The port's VacnicConfig: the file's preset with its overrides,
        held to the file's sizes (a preset changed since would measure
        another model)."""
        try:
            from vacnic_tpu_torch.core.config import VacnicConfig
        except ImportError as e:
            raise Refused(f"the port is not in this checkout ({e})") from e
        cfg = getattr(VacnicConfig, self.config["port_preset"])()
        for group, fields in self.config.get("port_overrides", {}).items():
            cfg = dataclasses.replace(cfg, **{group: dataclasses.replace(getattr(cfg, group),
                                                                         **fields)})
        s = self.sizes
        got = {"vocab_size": cfg.bart.vocab_size, "d_model": cfg.bart.d_model,
               "encoder_layers": cfg.bart.encoder_layers, "decoder_layers": cfg.bart.decoder_layers,
               "encoder_ffn_dim": cfg.bart.encoder_ffn_dim, "img_size": cfg.fusion.img_size,
               "prompt_size": cfg.fusion.prompt_size, "only_image": cfg.fusion.only_image,
               "max_ner_type_len": cfg.fusion.max_ner_type_len,
               "article_max_length": cfg.data.article_max_length,
               "num_beams": cfg.decode.num_beams, "max_length": cfg.decode.max_length,
               "min_length": cfg.decode.min_length, "length_penalty": cfg.decode.length_penalty,
               "train_batch_size": cfg.train.train_batch_size}
        bad = {k: (v, s[k]) for k, v in got.items() if k in s and v != s[k]}
        if bad:
            raise RuntimeError(f"the port's {self.config['port_preset']} differs from "
                               f"{self.config['name']}'s sizes: {bad}")
        return cfg

    def sub_seed(self, *path: int) -> int:
        """A seed for one part of the run (weights, a batch of inputs),
        from --seed and the part's numbers: splitmix64, 63 bits."""
        from portbench.reference.model import fold_in

        s = self.seed
        for p in path:
            s = fold_in(s, p)
        return s


@dataclasses.dataclass
class Outcome:
    e2e: dict                   # end-to-end metric name -> value
    attempted: int
    failed: int
    checks: list                # (name, value, limit): correct where value <= limit
    memory_peak_bytes: int
    records: Any = None         # portbench.trace.Records of the traced run
    notes: dict = dataclasses.field(default_factory=dict)  # printed to stderr


def model_inputs(batch: dict, device, only_image: bool) -> dict:
    """A synthetic batch (numpy) as the keyword inputs of the port's
    generate_mm, the masks made here: 1 where an id is not the pad id (1), a
    face where its row is not the pad row of ones."""
    t = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    x = dict(input_ids=t["article_ids"], attention_mask=(t["article_ids"] != 1).to(torch.int32),
             image_features=t["image_cls"] if "image_cls" in t else None)
    if not only_image:
        x.update(face_features=t["face_emb"],
                 face_mask=(t["face_emb"][:, :, -1] != 1).to(torch.int32),
                 name_ids=t["names_art_ids"],
                 name_mask=(t["names_art_ids"] != 1).to(torch.int32))
    return x


def sync(device) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def memory_peak(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if str(device).startswith("cuda") else 0


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------

def execute(bench: dict, cell: dict, *, seed: int, seconds: float, trace: bool, device: str,
            t_start: float, spec: dict | None = None, config: dict | None = None) -> dict:
    """Run `cell` and return its result line (a dict). `spec` and `config`
    replace the cell's files (the CPU tests' tiny configuration)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = spec or cell_spec(cell["name"])
    config = config or config_file(cell["config"])
    ctx = Context(name=cell["name"], spec=spec, config=config, seed=seed, seconds=seconds,
                  trace=trace, device=device, t_start=t_start)
    try:
        out: Outcome = driver_module(spec["driver"]).run(ctx)
    except ModuleNotFoundError as e:
        if (e.name or "").split(".")[0] == "vacnic_tpu_torch":
            raise Refused(f"the port is not in this checkout ({e})") from e
        raise

    metrics = {}
    if not trace:
        for m in end_to_end_for(bench, cell["name"]):
            if m["name"] not in out.e2e:
                raise RuntimeError(f"driver {spec['driver']} gave no {m['name']}")
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    else:
        for m in per_layer_for(bench, cell["name"]):
            v = metric_reader(m["name"]).read(out.records)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    dev = {"platform": "gpu" if device.startswith("cuda") else "cpu",
           "kind": torch.cuda.get_device_name(0) if device.startswith("cuda") else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": all(v <= lim for _, v, lim in out.checks) and bool(out.checks),
            "attempted": int(out.attempted), "failed": int(out.failed),
            "metrics": metrics, "device": dev}
    if trace and out.records is not None:
        dev["busy_s"] = out.records.busy_s()
        dev["window_s"] = out.records.window_s
        line["breakdown"] = {"device_ops": out.records.top_ops(10),
                             "idle_gaps": out.records.idle_gaps(10)}
    for k, v in out.notes.items():  # what a reader of the run needs beside the line
        print(f"note {k}: {v}", file=sys.stderr)
    line["checks"] = {name: {"value": float(v), "limit": float(lim)}
                      for name, v, lim in out.checks}
    return line


def emit(line: dict) -> None:
    """The checks as the last lines of standard error, the result as the
    last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
