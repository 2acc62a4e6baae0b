"""The comparison that decides `correct`.

Once the window has closed, a sample of the answers it returned (drawn
from the seed) is judged against the plain reference (reference/search.py),
which works each sampled query out again from the raw query and the trained
quantizer state by the search the configuration names (`adc_type`: "qadc",
Quick ADC of 4-bit codes, the default; "adc", conventional ADC of 8-bit
codes over IVF, the port's grouped adc8 search), and the build is judged on
a sample of base vectors:

  miss           the largest share, over the sampled answers, of r that
                 the answer gets wrong: codes it lacks that are nearer than
                 its farthest and that every valid search keeps, and codes
                 it returns that no valid search can; read as the
                 configuration's search (its exact screen's windows below
                 the cut value are kept, the windows tied at the cut may go
                 either way, which is the implementation's order: Quick
                 ADC's int8 window minima screened to `screen_windows` * r,
                 or 8-bit ADC's bfloat16 window minima screened to
                 r + max(16, r // 8)) and as exact ADC over the probes (the
                 program may serve a small batch by the exact path), the
                 smaller of the two;
  dist_err       the largest gap, over every (label, distance) the sampled
                 answers return, between the distance returned and the
                 reference's float ADC distance of that label's code for
                 that query, over the query's r-th reference distance; a
                 label that is no probed code of the query reads inf;
  code_mismatch  the share of the sampled base vectors whose stored
                 partition or code differs from the reference's encoding
                 under the trained quantizer, the stored codes decoded by
                 their bit width (4-bit nibbles or 8-bit bytes);
  train_excess   the training, judged by itself: how much worse the
                 program's trained quantizer reconstructs the sampled base
                 vectors than the reference's own (reference/train.py,
                 trained from the same learn set with a seed of its own),
                 D_program / D_reference - 1. The three numbers above follow
                 the program's trained state; this one takes none of it.

Each number is held to its limit from the configuration file's `limits`.
The control (`control=True`) puts the reference itself, computed one
precision lower, in the program's place: TF32 products and int4 tables for
Quick ADC; TF32 products and the rerank summed from the bfloat16 tables
(the screen's) for 8-bit ADC.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference import search as reference
from portbench.reference import train as ref_train

SAMPLE_ANSWERS = 256


@dataclasses.dataclass
class Answered:
    """Answers to judge: query ids (S,), labels and distances (S, r)."""

    qids: np.ndarray
    labels: np.ndarray
    dists: np.ndarray


def sample(qids: np.ndarray, labels, dists, seed: int, n: int = SAMPLE_ANSWERS) -> Answered:
    """n answers drawn from the seed among all that the window returned."""
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(qids), size=min(n, len(qids)), replace=False))
    return Answered(np.asarray(qids)[pick], np.asarray(labels)[pick], np.asarray(dists)[pick])


def _positions(state: reference.State) -> torch.Tensor:
    """(n,) flat storage position (partition * part_pad + slot) of each
    label's code, -1 for a label no real code carries."""
    n_parts, part_pad = state.labels.shape
    slot = torch.arange(part_pad, device=state.labels.device)
    real = slot[None, :] < state.sizes[:, None]
    flat_pos = (torch.arange(n_parts, device=slot.device)[:, None] * part_pad + slot[None, :])
    n = int(state.labels[real].max()) + 1 if bool(real.any()) else 0
    pos = torch.full((n,), -1, dtype=torch.int64, device=slot.device)
    pos[state.labels[real]] = flat_pos[real]
    return pos


def _misses(code_d, code_c, want_d, flat_at, found) -> torch.Tensor:
    """(S,) codes each answer should hold and does not, the fewer of two
    readings: as Quick ADC (a returned code whose window the screen cannot
    keep, and each SURE code nearer than the answer's farthest that it
    lacks) and as exact ADC over the probes (each probed code nearer than
    the answer's farthest that it lacks); in both, a returned label that is
    no probed code. Nearer means by a relative 1e-6, past rounding."""
    far = torch.where(found, want_d, torch.inf).amax(-1, keepdim=True) * (1.0 - 1e-6)
    nearer = code_d < far                                                  # (S, ma * pad)
    held = torch.zeros_like(nearer)
    held.scatter_(1, torch.where(found, flat_at, 0), found)
    lost = (~found).sum(-1)
    cls = torch.gather(code_c, 1, flat_at)
    quick = lost + ((cls == reference.OUT) & found).sum(-1) + (
        nearer & (code_c == reference.SURE) & ~held).sum(-1)
    exact = lost + (nearer & ~held).sum(-1)
    return torch.minimum(quick, exact).float()


def train_excess(dep, control: bool = False) -> float:
    """D_program / D_reference - 1 on the sampled base vectors (see the
    module's docstring); with control=True the reference trained in TF32
    stands in the program's place."""
    from portbench.deploy import subseed

    def reference_model(low: bool):
        gen = torch.Generator(device=dep.learn.device).manual_seed(
            subseed(dep.seed, "reference-train"))
        with reference.precision(low=low):
            return ref_train.train(gen, dep.learn, dep.cfg)

    if control:
        have = reference_model(low=True)
    else:
        state = dep.state()
        have = ref_train.Model(state.coarse, state.rotation, state.codebooks)
    with reference.precision():
        want = ref_train.distortion(reference_model(low=False), dep.check_vectors)
        return ref_train.distortion(have, dep.check_vectors) / want - 1.0


def searched(state: reference.State, queries: torch.Tensor, cfg: dict,
             low: bool = False) -> reference.Answers:
    """The reference's answers by the configuration's search; low=True: the
    control, one precision below what the configuration states."""
    r, ma = cfg["r"], cfg.get("ma", 1)
    with reference.precision(low=low):
        if cfg.get("adc_type", "qadc") == "adc":
            return reference.search_adc8(state, queries, r, ma,
                                         rerank=torch.bfloat16 if low else torch.float32)
        return reference.search(state, queries, r, ma, cfg["keep"], cfg["screen_windows"],
                                levels=reference.INT4_LEVELS if low else reference.INT8_LEVELS)


def judge(dep, got: Answered, control: bool = False) -> dict:
    """The four numbers of a run (see the module's docstring). dep: the
    deployment (deploy.Deployment) whose index answered."""
    cfg = dep.cfg
    state = dep.state()
    dev = state.codes.device
    r = cfg["r"]
    uq, inv = np.unique(got.qids, return_inverse=True)
    inv_t = torch.as_tensor(inv, device=dev)
    queries = dep.pool[torch.as_tensor(uq, device=dev)]
    ref = searched(state, queries, cfg)
    if control:
        low = searched(state, queries, cfg, low=True)
        labels, dists = low.labels[inv_t], low.dists[inv_t]
    else:
        labels = torch.as_tensor(got.labels, device=dev).to(torch.int64)
        dists = torch.as_tensor(got.dists, device=dev).to(torch.float32)

    pos = _positions(state)
    part_pad = state.labels.shape[1]
    safe = labels.clamp(min=0, max=max(pos.shape[0] - 1, 0))
    at = torch.where(labels >= 0, pos[safe], -1)                            # (S, r)
    part, slot = at // part_pad, at % part_pad
    hit = (ref.probes[inv_t][:, None, :] == part[:, :, None]) & (at[:, :, None] >= 0)
    flat_at = hit.to(torch.int64).argmax(-1) * part_pad + slot.clamp(min=0)  # (S, r)
    found = hit.any(-1)
    code_d = ref.code_dists[inv_t].reshape(len(inv), -1)                  # (S, ma * pad)
    code_c = ref.code_class[inv_t].reshape(len(inv), -1)
    want_d = torch.where(found, torch.gather(code_d, 1, flat_at), torch.inf)
    scale = ref.dists[inv_t][:, -1:].clamp(min=1e-30)
    err = torch.where(torch.isfinite(want_d), (dists - want_d).abs() / scale, torch.inf)
    miss = _misses(code_d, code_c, want_d, flat_at, found) / r

    # The build: each sampled base vector's partition and code.
    with reference.precision():
        want_part, want_code = reference.encode(state, dep.check_vectors)
    if control:
        with reference.precision(low=True):
            have_part, have_code = reference.encode(state, dep.check_vectors)
    else:
        loc = pos[dep.check_ids]
        stored = state.codes.reshape(-1, state.codes.shape[-1])[loc.clamp(min=0)]
        have_code = reference.decode(stored, state.sq_count, state.k)
        have_part = torch.where(loc >= 0, loc // part_pad, -1)
    bad = (have_part != want_part) | (have_code != want_code).any(-1)
    return {"miss": float(miss.max()), "dist_err": float(err.max()),
            "code_mismatch": float(bad.float().mean()),
            "train_excess": train_excess(dep, control)}


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    shown = {k: {"value": numbers[k], "limit": limits[k]} for k in numbers}
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return ok, shown
