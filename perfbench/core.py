"""What every driver shares: cells found by name, seeded streams, the
weights made from the seed, the program's config, and the result line.

A cell is one entry of ``BENCHMARK.json``'s ``workloads``: its
configuration file (``configs/<config>.json``, the published keys as
run plus the notes on the cut) and its traffic mix
(``traffic/<traffic>.json``, which names the driver that runs it).
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

#: Top-level module names that may not be loaded in a run's process:
#: JAX and the JAX package.  Names are compared whole, so the port
#: (``tpu_autoscaler_torch``) is not among them.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_autoscaler")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_benchmark(repo: Path = REPO) -> dict:
    return json.loads((repo / "BENCHMARK.json").read_text())


def traffic_path(name: str, root: Path = HERE) -> Path:
    return root / "traffic" / f"{name}.json"


def metric_path(name: str, root: Path = HERE) -> Path:
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``,
    else the reader of its quantity, ``metrics/<part before the first
    dot>.py`` (one reader for ``idle_share.serve`` and
    ``idle_share.train``, whose names say only what they move)."""
    path = root / "metrics" / f"{name}.py"
    if not path.exists():
        path = root / "metrics" / f"{name.split('.')[0]}.py"
    return path


def load_cell(name: str, repo: Path = REPO, root: Path = HERE) -> Cell:
    """The cell ``name`` of ``repo``'s BENCHMARK.json, with its config,
    its mix and the metrics it reports."""
    bench = load_benchmark(repo)
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(by_name)})")
    work = by_name[name]
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = json.loads((repo / entry["file"]).read_text())
    mix = json.loads(traffic_path(work["traffic"], root).read_text())
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return Cell(name=name, chips=work["chips"], config=config, mix=mix,
                end_to_end=e2e, per_layer=per_layer)


def driver_for(cell: Cell):
    """The module that runs the cell's mix: ``drivers/<driver>.py``."""
    return importlib.import_module(f"perfbench.drivers.{cell.mix['driver']}")


def read_metric(name: str, record: dict, root: Path = HERE):
    """Per-layer metric ``name`` read from a traced run's ``record`` by
    the ``read`` of :func:`metric_path`; None where it finds nothing."""
    path = metric_path(name, root)
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(record)


def forbidden_loaded() -> list[str]:
    """The forbidden top-level module names in ``sys.modules``."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN_MODULES))


# ---- seeds ----------------------------------------------------------------

def _key(part) -> int:
    if isinstance(part, int):
        return part % 2**64
    return int.from_bytes(hashlib.sha256(str(part).encode()).digest()[:8],
                          "little")


def stream_seed(seed: int, *key) -> int:
    """A 63-bit seed for the stream ``key`` of run ``seed``: any whole
    number, negative or past 64 bits, names one run."""
    ss = np.random.SeedSequence(_key(seed), spawn_key=tuple(map(_key, key)))
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *key) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, *key))


def torch_generator(seed: int, device, *key):
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, *key))
    return gen


# ---- the model: shapes, weights, the program's config ----------------------

def param_shapes(config: dict) -> dict:
    """The program's parameter layout for ``config`` (published keys):
    stacked layers, packed q|k|v columns, untied embedding and
    unembedding; '/'-joined paths."""
    L, d = config["num_hidden_layers"], config["hidden_size"]
    f, V = config["intermediate_size"], config["vocab_size"]
    hd = d // config["num_attention_heads"]
    kv = config["num_key_value_heads"]
    return {"embed": (V, d), "blocks/qkv": (L, d, d + 2 * kv * hd),
            "blocks/attn_out": (L, d, d), "blocks/w1": (L, d, f),
            "blocks/w2": (L, f, d), "blocks/ln1": (L, d),
            "blocks/ln2": (L, d), "ln_f": (d,), "unembed": (d, V)}


def is_gain(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in ("ln1", "ln2", "ln_f")


def make_leaf(config: dict, seed: int, path: str, dtype, device):
    """One weight, made on ``device`` from the seed in one call: normal
    with the config's ``initializer_range`` as its deviation, gains of
    one.  Each leaf has a stream of its own, so any one can be made
    again alone."""
    import torch

    shape = param_shapes(config)[path]
    if is_gain(path):
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch_generator(seed, device, "weights", path)
    out = torch.randn(shape, generator=gen, dtype=dtype, device=device)
    return out.mul_(config["initializer_range"])


def nest(flat: dict) -> dict:
    out: dict = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def make_weights(config: dict, seed: int, dtype, device) -> dict:
    """Every weight of ``config`` as the program's nested params."""
    return nest({path: make_leaf(config, seed, path, dtype, device)
                 for path in param_shapes(config)})


def matmul_params(config: dict) -> int:
    """Parameters of the blocks' four matrices, which every token goes
    through; the unembedding is :func:`unembed_params` (the embedding is
    a gather and the gains are elementwise, so neither counts)."""
    shapes = param_shapes(config)
    return sum(int(np.prod(shapes[p])) for p in (
        "blocks/qkv", "blocks/attn_out", "blocks/w1", "blocks/w2"))


def unembed_params(config: dict) -> int:
    return config["hidden_size"] * config["vocab_size"]


def port_config(config: dict, *, seq_len: int, **extra):
    """The program's ModelConfig for ``config``'s published keys, bf16
    compute.  Refuses a block the program does not have."""
    import torch

    from tpu_autoscaler_torch.workloads.model import ModelConfig

    if config["hidden_act"] != "gelu_pytorch_tanh":
        raise ValueError(f"the program's MLP is gelu (tanh); the config "
                         f"asks {config['hidden_act']!r}")
    return ModelConfig(
        vocab=config["vocab_size"], d_model=config["hidden_size"],
        n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"],
        d_ff=config["intermediate_size"], seq_len=seq_len,
        attention_window=config["sliding_window"],
        rope_theta=float(config["rope_theta"]), dtype=torch.bfloat16,
        **extra)


# ---- the result -------------------------------------------------------------

@dataclasses.dataclass
class Check:
    """One number compared, with its limit: correct iff value <= limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics, the record the
    per-layer readers read, the numbers compared, the counts, the
    device, and (``--control 1``) the control's readings."""
    e2e: dict
    record: dict
    checks: list
    attempted: int
    failed: int
    device: dict
    traced: dict | None
    control: dict | None = None
    notes: dict = dataclasses.field(default_factory=dict)


def sync(device) -> None:
    """Wait for the device's queued work (nothing to wait for on the
    CPU, where the tests run the drivers)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(torch, chips: int, traced: dict | None, device) -> dict:
    if torch.device(device).type != "cuda":
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(max(
                    torch.cuda.max_memory_allocated(i)
                    for i in range(chips)))}
    if traced is not None:
        info["busy_s"] = traced["busy_s"]
        info["window_s"] = traced["window_s"]
    return info


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) of ``values``, linear between ranks."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))
