"""Three-term roofline of a dry-run cell (port of
``repro.roofline.analysis``).

    compute term    = FLOPs            / (chips × peak FLOP/s)
    memory term     = bytes            / (chips × HBM rate)
    collective term = collective bytes / link rate

FLOPs and bytes are the global walk's (``jaxpr_cost``).  The collective
bytes are the ones the port's own mesh code moves between coordinates
(``distributed.sharding.record_collective``: the expert-parallel
all-to-alls, the pipeline's ring, the partitioned executors' gathers),
over the chips: a per-device figure, as the reference's.  The reference
parses them from the compiled HLO, where GSPMD has also put the FSDP and
tensor-parallel collectives; a one-process port has no counterpart of
those, so the report says ``"collectives_modelled": "port mesh code
only"``.  The HLO text parsers (``collective_bytes`` and its helpers)
are the reference's, kept for reading such text.

Hardware constants: NVIDIA H100 80GB HBM3 (SXM5), 700 W, from NVIDIA's
data sheet.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional

# NVIDIA H100 80GB HBM3, 700 W: dense bf16 tensor-core FLOP/s
PEAK_FLOPS = 989e12
# NVIDIA H100 80GB HBM3, 700 W: HBM3 bytes/s
HBM_BW = 3.35e12
# NVIDIA H100 80GB HBM3, 700 W: NVLink 4 bytes/s one direction a GPU
# (900 GB/s both ways)
ICI_BW = 450e9

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# one result/operand shape, e.g. bf16[16,4096]{1,0}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(dtype: str, dims: str) -> int:
    if dtype not in _DTYPE_BYTES:
        return 0
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * _DTYPE_BYTES[dtype]


def _split_computations(hlo_text: str) -> Dict[str, str]:
    """Split module text into named computation bodies.

    Brace-depth tracking: layout braces like ``{1,0}`` open and close on the
    same line so per-line net counts are safe; a computation header is the
    first net-opening line while outside any computation."""
    comps: Dict[str, list] = {}
    current = None
    depth = 0
    for line in hlo_text.splitlines():
        net = line.count("{") - line.count("}")
        if current is None:
            if net > 0 and "{" in line:
                m = re.search(r"(?:ENTRY\s+)?%([\w.\-]+)\s*\(", line)
                name = m.group(1) if m else f"__anon{len(comps)}"
                current = name
                comps[name] = []
                depth = net
            continue
        depth += net
        if depth <= 0:
            current = None
            continue
        comps[current].append(line)
    return {k: "\n".join(v) for k, v in comps.items()}


_CALL_RE = re.compile(
    r"(?:body|to_apply|condition|calls)=%?([\w.\-]+)")
_BODY_RE = re.compile(r"body=%?([\w.\-]+)")
_COND_RE = re.compile(r"condition=%?([\w.\-]+)")
_BRANCH_RE = re.compile(r"branch_computations=\{([^}]*)\}")
# trip bound: an s32 scalar constant inside the loop *condition* only
_TRIP_RE = re.compile(r"s32\[\]\s+constant\((\d+)\)")


def _computation_multiplicities(comps: Dict[str, str]) -> Dict[str, float]:
    """How many times each computation executes per step, following
    while-loop bodies (× trip count) and fusion/call edges (× 1)."""
    entry = None
    for name in comps:
        if "main" in name or entry is None:
            if "main" in name:
                entry = name
    if entry is None:
        entry = next(iter(comps))

    mult: Dict[str, float] = {name: 0.0 for name in comps}

    def visit(name: str, k: float):
        if name not in comps or k <= 0:
            return
        if mult[name] >= k and mult[name] > 0:
            # already visited with ≥ multiplicity (conservative max)
            mult[name] = max(mult[name], k)
            return
        mult[name] = max(mult[name], k)
        body = comps[name]
        for line in body.splitlines():
            factor = k
            if " while(" in line:
                # trip count: scan lowers the bound as an s32[] constant
                # inside the loop *condition* computation
                cond = _COND_RE.search(line)
                loop_body = _BODY_RE.search(line)
                trip = 1.0
                if cond and cond.group(1) in comps:
                    tm = _TRIP_RE.findall(comps[cond.group(1)])
                    if tm:
                        trip = min(max(float(t) for t in tm), 1e6)
                    visit(cond.group(1), factor * max(trip, 1.0))
                if loop_body and loop_body.group(1) in comps:
                    visit(loop_body.group(1), factor * max(trip, 1.0))
                continue
            for callee in _CALL_RE.findall(line):
                visit(callee, factor)
            bm = _BRANCH_RE.search(line)
            if bm:
                for callee in bm.group(1).replace("%", "").split(","):
                    visit(callee.strip(), factor)

    visit(entry, 1.0)
    return mult


def collective_bytes(hlo_text: str, top_n: int = 0):
    """Per-collective-kind byte totals from optimized HLO text, with
    while-loop (scan) bodies multiplied by their trip counts.

    With ``top_n`` > 0 also returns the top individual collective ops by
    total bytes — the §Perf profiling view (shape × trips × kind)."""
    comps = _split_computations(hlo_text)
    mult = _computation_multiplicities(comps)
    totals = {k: 0.0 for k in _COLLECTIVES}
    ops = []
    for name, body in comps.items():
        k = mult.get(name, 1.0)
        if k <= 0:
            continue
        for line in body.splitlines():
            stripped = line.strip()
            for kind in _COLLECTIVES:
                m = re.search(r"=\s+(.*?)\s+" + kind + r"(?:-start)?\(",
                              stripped)
                if not m:
                    continue
                if kind + "-done(" in stripped:
                    continue  # -done pairs with -start; count once
                shapes = m.group(1)
                nbytes = sum(_shape_bytes(dt, dims)
                             for dt, dims in _SHAPE_RE.findall(shapes))
                if kind == "all-reduce":
                    nbytes *= 2          # RS + AG decomposition
                widened = ("promoted" in stripped
                           or re.search(r"\(%convert", stripped)
                           or "convert" in stripped.split("(", 1)[-1][:160])
                if widened and "f32[" in shapes:
                    # XLA:CPU widens bf16 collectives to f32 (promoted
                    # all-reduce accumulation / converted operands); the
                    # algorithmic wire dtype is bf16 — charge wire bytes
                    # (EXPERIMENTS §Perf iteration 2; verified against the
                    # jaxpr-level payload dtypes).
                    nbytes *= 0.5
                totals[kind] += nbytes * k
                if top_n:
                    ops.append({"kind": kind, "shape": shapes[:80],
                                "trips": k, "bytes": nbytes * k,
                                "computation": name})
                break
    if top_n:
        ops.sort(key=lambda o: -o["bytes"])
        return totals, ops[:top_n]
    return totals


@dataclasses.dataclass
class Roofline:
    """Three-term roofline.

    flops/bytes are GLOBAL (pre-partition, from the aten walker,
    ``jaxpr_cost``); collective bytes are PER-DEVICE (the port's mesh
    code's, over the chips).
    """

    flops: float                       # global HLO-equivalent flops
    bytes_accessed: float              # global bytes (materialization pts)
    coll_bytes: Dict[str, float]       # per-device, by collective kind
    chips: int
    xla_cost: Optional[Dict] = None    # no compiled artifact: always None

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def compute_s(self) -> float:
        return self.flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.bytes_accessed / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        return self.total_coll_bytes / ICI_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline-optimistic step time: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def summary(self, model_flops_global: Optional[float] = None) -> Dict:
        out = {
            "global_flops": self.flops,
            "global_bytes": self.bytes_accessed,
            "collective_bytes_per_device": self.total_coll_bytes,
            "collectives": {k: v for k, v in self.coll_bytes.items() if v},
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
        }
        if self.xla_cost:
            out["xla_cost_analysis"] = self.xla_cost
        if model_flops_global:
            out["model_flops_global"] = model_flops_global
            out["useful_flop_ratio"] = (model_flops_global
                                        / max(self.flops, 1.0))
            # fraction of roofline: useful work over what the dominant
            # resource allows in the same time
            out["roofline_fraction"] = (
                model_flops_global / (self.chips * PEAK_FLOPS)
                / max(self.step_time_s, 1e-12))
        return out


def analyze(cost, chips: int, coll_bytes: Optional[Dict[str, float]] = None
            ) -> Roofline:
    """The :class:`Roofline` of a walk: ``cost`` a ``jaxpr_cost.Cost``
    (global FLOPs and bytes), ``coll_bytes`` the bytes moved between mesh
    coordinates by kind, summed over them (default: the walk's own,
    ``cost.collectives``), charged per device."""
    moved = cost.collectives if coll_bytes is None else coll_bytes
    per_device = {k: 0.0 for k in _COLLECTIVES}
    for kind, nbytes in moved.items():
        per_device[kind] += nbytes / chips
    return Roofline(flops=cost.flops, bytes_accessed=cost.bytes,
                    coll_bytes=per_device, chips=chips)


def _leaf_bytes(shape, dtype_size: int, spec, mesh_shape) -> float:
    """One leaf's bytes on one device under ``spec``: its bytes over the
    product of the mesh axes the spec names."""
    div = 1
    for entry in spec:
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else entry):
            div *= mesh_shape[ax]
    return math.prod(shape) * dtype_size / div


def sharded_bytes(leaves) -> float:
    """Per-device bytes of ``(shape, dtype_size, spec, mesh_shape)``
    leaves."""
    return sum(_leaf_bytes(*leaf) for leaf in leaves)


def memory_report(argument_leaves, output_leaves, temp_bytes: float,
                  batch_div: int, alias_leaves=()) -> Dict[str, float]:
    """The reference's per-device memory report, reckoned from the walk
    (there is no compiled artifact to read):

    * ``argument_size_in_bytes``: every argument leaf's bytes over the
      product of the mesh axes its spec names (exact);
    * ``output_size_in_bytes``: the same over the output specs the
      reference's dry run gives its outputs;
    * ``temp_size_in_bytes``: the walk's peak of live bytes it allocated
      (``Cost.peak_bytes``, at the global shape) over ``batch_div``, the
      size of the mesh axes the batch's spec shards.  An approximation:
      it treats every temporary as sharded like the batch (weights'
      gradients and optimizer temporaries are sharded otherwise, or not
      at all), counts the eager allocations of a walk (no fusion, no
      rematerialization by a compiler), and includes the outputs live at
      the end;
    * ``alias_size_in_bytes``: the donated arguments (the train step's
      parameters and optimizer state, the decode state);

    each leaf given as ``(shape, dtype_size, spec, mesh_shape)``."""
    out = {"argument_size_in_bytes": sharded_bytes(argument_leaves),
           "output_size_in_bytes": sharded_bytes(output_leaves),
           "temp_size_in_bytes": float(temp_bytes) / batch_div,
           "alias_size_in_bytes": sharded_bytes(alias_leaves)}
    out["total_hbm_bytes"] = (
        out["argument_size_in_bytes"] + out["output_size_in_bytes"]
        + out["temp_size_in_bytes"] - out["alias_size_in_bytes"])
    return out


def model_flops(cfg, shape, param_count_active: int) -> float:
    """6·N·D model flops for train (3 passes), 2·N·D for inference, plus
    the quadratic attention term where applicable."""
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        passes = 6.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        passes = 2.0
    else:  # decode: one token per row
        tokens = shape.global_batch * 1
        passes = 2.0
    base = passes * param_count_active * tokens

    # attention score/context flops (per token pair: 2×2×hd per head)
    attn_layers = sum(1 for k in cfg.block_kinds()
                      if k in ("attn", "local_attn"))
    if attn_layers and cfg.head_dim:
        s = shape.seq_len
        if shape.kind == "decode":
            ctx = min(s, cfg.window) if cfg.window else s
            pair_count = shape.global_batch * 1 * ctx
        else:
            w = cfg.window or s
            # causal: ~ s*min(s,w) - triangle correction
            per_row = min(s, w)
            pair_count = shape.global_batch * s * per_row / (
                2 if w >= s else 1)
        mult = 3.0 if shape.kind == "train" else 1.0
        base += (mult * 4 * cfg.n_heads * cfg.head_dim
                 * pair_count)
    return base
