"""Baum-Welch EM training of the pair-HMM on the data itself, on one torch
device.

Port of marginalign_trna_tpu/align/em.py (the TPU-native replacement for
cPecan's jobTree EM driver, cPecanEm.expectationMaximisationTrials, called
at src/margin/marginAlignLib.py:219-221): multiple random-start trials,
each running iterations of (E-step: banded forward-backward expected counts
over all read/ref segments, ops/fb_counts.py; M-step: row
renormalisation), keeping the maximum-likelihood trial.  By default the
trials run in lockstep: one launch per kernel and batch computes every
trial's counts.  Training state checkpoints after every iteration
(align/checkpoint.py, the JAX package's file format).

Reference defaults mirrored from src/margin/marginAlign.py:38-53:
trials=3, iterations=100, randomStart=True, maxAlignmentLengthToSample=50M.

With update_band_every > 0 (--updateTheBand) the band is re-derived during
training by MEA-realigning the training pairs with the mid-training model,
whose gap emissions are not flat: the realignment takes the REL path and
the generic forward-backward pair (align/realign.py).

With multi=True (the JAX package's MARGINALIGN_MULTI=on) the E-step packs
the training pairs several per lane (ops/band.py `pack_multi_banded_batch`,
lanes of 1024 diagonals) and runs the multi-lane counts kernels
(ops/fb_counts.py `fb_counts_multi(_trials)`); band updates realign in
multi-problem lanes where align/realign.py's policy allows.

Not ported yet, refused with NotImplementedError: training sharded over
several processes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.hmm import GAP_X_STATES, MODEL_TYPES, PairHmm
from ..ops.band import (
    pack_banded_batch, pack_multi_banded_batch, path_from_cigar,
)
from ..ops.fb import (
    device_batch, multi_device_batch, tables_from_hmm, tables_stacked,
)
from ..ops.fb_counts import (
    fb_counts, fb_counts_multi, fb_counts_multi_trials, fb_counts_trials,
)
from .realign import (
    DEFAULT_BAND_WIDTH, RealignJob, _bucket_jobs, realigned_ops_for_jobs,
)


@dataclass
class EmOptions:
    """EM options, mirroring the cPecanEm.Options surface the reference
    configures (src/margin/marginAlign.py:38-53)."""

    trials: int = 3
    iterations: int = 100
    random_start: bool = True
    # Model family (reference: cPecanEm modelType, marginAlign.py:40).
    model_type: str = "fiveStateAsymmetric"
    max_alignment_length_to_sample: int = 50_000_000
    band_width: int = DEFAULT_BAND_WIDTH
    # Split EM DP problems at guide anchors so no side exceeds this
    # (reference EM realign options --splitMatrixBiggerThanThis=300,
    # src/margin/marginAlign.py:41); 0 = exact full-length DP.
    split_size: int = 300
    # Start trial 0 from the input model instead of a random start; the
    # remaining trials stay random (reference: useDefaultModelAsStart).
    use_default_model_as_start: bool = False
    # Padded DP cells per E-step batch.
    max_batch_cells: int = 88_000_000
    seed: int = 0
    # Early-exit when the total log-likelihood improves by less than this.
    tolerance: float = 1e-3
    train_emissions: bool = True
    # Tie short and long gap-state emissions (reference: tieEmissions).
    tie_emissions: bool = False
    # Write each trial's trained model to <path>.trial<N> (outputTrialHmms).
    output_trial_hmms_path: Optional[str] = None
    # Start emissions at a Jukes-Cantor matrix with this substitution rate
    # instead of random/flat (reference: setJukesCantorStartingEmissions).
    jukes_cantor_start: Optional[float] = None
    # Run all random-start trials in lockstep (one launch per kernel and
    # batch for every trial) instead of the reference's serial trials.
    lockstep: bool = True
    # Re-derive the EM band every k iterations (cPecanEm updateTheBand);
    # 0 = off, the default.
    update_band_every: int = 0


@dataclass
class EmTrialResult:
    hmm: PairHmm
    likelihood: float
    likelihood_history: List[float]


def _m_step(
    hmm: PairHmm,
    trans_counts: np.ndarray,
    emit_match: np.ndarray,
    emit_gap: np.ndarray,
    train_emissions: bool,
) -> PairHmm:
    """Row-renormalise expected counts into new parameters.  Rows with no
    mass keep their previous values (cPecan keeps the old row too)."""
    new = hmm.copy()
    row = trans_counts.sum(axis=1, keepdims=True)
    ok = row[:, 0] > 0
    new.transitions[ok] = trans_counts[ok] / row[ok]

    if train_emissions:
        # Match state: drop the N row/column, renormalise over ACGT x ACGT.
        m4 = emit_match[:4, :4]
        if m4.sum() > 0:
            new.emissions[0] = (m4 / m4.sum()).reshape(-1)
        # Gap states: the per-base marginal expands to a 16-vector, uniform
        # over the silent axis (the reference flattens gap emissions after
        # training anyway; marginAlignLib.py:229).
        for s in range(1, 5):
            marg = emit_gap[s, :4]
            if marg.sum() <= 0:
                continue
            marg = marg / marg.sum()
            e = np.empty((4, 4))
            if s in GAP_X_STATES:
                e[:, :] = marg[:, None] / 4.0
            else:
                e[:, :] = marg[None, :] / 4.0
            new.emissions[s] = e.reshape(-1)
    return new


def prepare_em_batches(
    jobs: Sequence[RealignJob],
    band_width: int = DEFAULT_BAND_WIDTH,
    max_batch_cells: int = 88_000_000,
    device="cuda",
    multi: bool = False,
) -> List[Tuple[str, object, int]]:
    """Pack jobs into E-step batches on `device` ONCE per training run (the
    band geometry does not change between iterations): host band arrays
    (ops/band.py `pack_banded_batch`, size-sorted buckets) uploaded as
    ("single", DeviceBatch, n_real), or with multi=True (the JAX package's
    MARGINALIGN_MULTI=on) the jobs in order, in chunks of at most
    max_batch_cells / (1024 * band_width) lanes of 1024 diagonals, each
    packed several per lane (`pack_multi_banded_batch`) and uploaded as
    ("multi", MultiDeviceBatch, P) (marginalign_trna_tpu/align/em.py
    :159-185)."""
    out: List[Tuple[str, object, int]] = []
    if multi:
        d1 = 1024
        max_lanes = max(1, max_batch_cells // (d1 * band_width))
        chunks: List[List[RealignJob]] = []
        chunk: List[RealignJob] = []
        steps = 0
        for j in jobs:
            need = len(j.read_region) + len(j.ref_region) + 3
            if chunk and -(-(steps + need) // d1) > max_lanes:
                chunks.append(chunk)
                chunk, steps = [], 0
            chunk.append(j)
            steps += need
        if chunk:
            chunks.append(chunk)
        for chunk in chunks:
            mb = pack_multi_banded_batch(
                [j.read_region for j in chunk], [j.ref_region for j in chunk],
                width=band_width, paths=[j.path for j in chunk],
                pad_steps_to=d1,
            )
            out.append(("multi", multi_device_batch(mb, device), len(chunk)))
        return out
    for bucket in _bucket_jobs(jobs, band_width, max_batch_cells):
        batch = pack_banded_batch(
            [jobs[i].read_region for i in bucket],
            [jobs[i].ref_region for i in bucket],
            width=band_width,
            paths=[jobs[i].path for i in bucket],
            quantize=True,
        )
        out.append(("single", device_batch(batch, device), len(bucket)))
    return out


def _counts_pipelined(batches, call_for_kind):
    """Queue every batch's expected-counts launches
    (call_for_kind[kind](batch), kind "single" or "multi") without waiting,
    then synchronise once and pull the small results in order: yields
    (numpy arrays tuple, n_real) per batch (n_real: lanes, or problems of a
    multi batch, whose logZ is per problem)."""
    pending = [(call_for_kind[kind](dev), n_real)
               for kind, dev, n_real in batches]
    for dev in {dev.xb.device for _, dev, _ in batches if dev.xb.is_cuda}:
        torch.cuda.synchronize(dev)
    for res, n_real in pending:
        yield tuple(a.cpu().numpy() for a in res), n_real


def _batch_device(batches) -> torch.device:
    """The device the batches live on (any, when there are none)."""
    return batches[0][1].xb.device if batches else torch.device("cpu")


def expectation_step(
    batches: List[Tuple[str, object, int]],
    hmm: PairHmm,
    psum_fn=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """Expected counts + total log-likelihood over prepared batches
    (prepare_em_batches).  psum_fn, when given, merges the count tensors
    across data-parallel workers."""
    tables = tables_from_hmm(hmm, _batch_device(batches))
    tc = np.zeros((5, 5))
    em = np.zeros((5, 5))
    eg = np.zeros((5, 5))
    total_ll = 0.0
    calls = {"single": lambda d: fb_counts(tables, d),
             "multi": lambda d: fb_counts_multi(tables, d)}
    for (logZ, tc_b, em_b, eg_b), n_real in _counts_pipelined(batches,
                                                              calls):
        total_ll += float(np.sum(logZ[:n_real]))
        tc += tc_b.astype(np.float64)
        em += em_b.astype(np.float64)
        eg += eg_b.astype(np.float64)
    if psum_fn is not None:
        tc, em, eg, total_ll = psum_fn(tc, em, eg, total_ll)
    return tc, em, eg, total_ll


def expectation_step_trials(
    batches: List[Tuple[str, object, int]],
    hmms: Sequence[PairHmm],
    psum_fn=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Expected counts + per-trial total log-likelihood for ALL trials over
    prepared batches: one launch per kernel and batch whatever the trial
    count.  Returns ([Ntr,5,5] x3, [Ntr])."""
    tables = tables_stacked(hmms, _batch_device(batches))
    ntr = len(hmms)
    tc = np.zeros((ntr, 5, 5))
    em = np.zeros((ntr, 5, 5))
    eg = np.zeros((ntr, 5, 5))
    total_ll = np.zeros(ntr)
    calls = {"single": lambda d: fb_counts_trials(tables, d),
             "multi": lambda d: fb_counts_multi_trials(tables, d)}
    for (logZ, tc_b, em_b, eg_b), n_real in _counts_pipelined(batches,
                                                              calls):
        total_ll += logZ[:, :n_real].sum(axis=1)
        tc += tc_b.astype(np.float64)
        em += em_b.astype(np.float64)
        eg += eg_b.astype(np.float64)
    if psum_fn is not None:
        tc, em, eg, total_ll = psum_fn(tc, em, eg, total_ll)
    return tc, em, eg, total_ll


def sample_jobs(
    jobs: List[RealignJob], max_bases: int, seed: int = 0
) -> List[RealignJob]:
    """Cap the total aligned read bases used for training
    (maxAlignmentLengthToSample, src/margin/marginAlign.py:47)."""
    if sum(len(j.read_region) for j in jobs) <= max_bases:
        return jobs
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(jobs))
    out, total = [], 0
    for idx in order:
        n = len(jobs[idx].read_region)
        if total + n > max_bases and out:
            break
        out.append(jobs[idx])
        total += n
    return out


def _tie_gap_emissions(hmm: PairHmm) -> None:
    """Tie short/long gap-state emissions (average 1<->3 and 2<->4)."""
    for a, b in ((1, 3), (2, 4)):
        avg = 0.5 * (hmm.emissions[a] + hmm.emissions[b])
        hmm.emissions[a] = avg
        hmm.emissions[b] = avg.copy()


def _init_trial_hmm(
    options: EmOptions, input_hmm: Optional[PairHmm], trial: int
) -> PairHmm:
    from_input = input_hmm is not None and (
        not options.random_start
        or (options.use_default_model_as_start and trial == 0)
    )
    if from_input:
        hmm = input_hmm.copy()
    else:
        hmm = PairHmm.random(seed=options.seed * 1000 + trial)
    hmm.model_type = MODEL_TYPES[options.model_type]
    if options.jukes_cantor_start is not None:
        r = options.jukes_cantor_start
        jc = np.full((4, 4), r / 3.0)
        np.fill_diagonal(jc, 1.0 - r)
        hmm.emissions[0] = (jc / jc.sum()).reshape(-1)
    hmm.apply_model_type_constraints()
    if options.tie_emissions:
        _tie_gap_emissions(hmm)
    return hmm


def _update_band_jobs(jobs: List[RealignJob], hmm: PairHmm,
                      options: EmOptions, device,
                      multi: bool) -> List[RealignJob]:
    """Re-derive each training pair's band path by MEA-realigning it with
    the current model on `device` (EmOptions.update_band_every; gap gamma
    0.5, match gamma 0, no anchor split: marginalign_trna_tpu/align/em.py
    `_update_band_jobs`), in multi-problem lanes with multi=True where
    align/realign.py's policy allows (a mid-training model, whose gap
    emissions are not flat, takes the REL path)."""
    ops_list = realigned_ops_for_jobs(jobs, hmm, 0.5, 0.0, device,
                                      options.band_width, split_size=0,
                                      multi=multi)
    out = []
    for job, ops in zip(jobs, ops_list):
        aligned = [(op, ln) for op, ln in ops if op in (0, 1, 2)]
        if not aligned:
            out.append(job)
            continue
        out.append(RealignJob(
            record=job.record, read_region=job.read_region,
            ref_region=job.ref_region, path=path_from_cigar(aligned),
        ))
    return out


def _train_em_lockstep(
    batches: List[Tuple[str, object, int]],
    options: EmOptions,
    input_hmm: Optional[PairHmm],
    psum_fn,
    log_fn,
    checkpoint_path: Optional[str],
    jobs: List[RealignJob],
    device,
    multi: bool,
) -> EmTrialResult:
    """All trials advance together: per iteration, one launch per kernel
    and E-step batch computes every trial's counts.  Trial trajectories are
    the serial path's (same seeds, same per-trial arithmetic) except under
    update_band_every: lockstep trials share one band, re-derived from the
    current best trial's model, where serial trials keep their own (the JAX
    package's documented deviation).  Converged trials freeze (their
    parameters stop updating) until all are done."""
    from .checkpoint import EmLockstepCheckpoint

    ntr = options.trials
    ck = EmLockstepCheckpoint.try_load(checkpoint_path)
    if ck is not None and ck.transitions.shape[0] == ntr:
        hmms = ck.hmms()
        for h in hmms:
            h.model_type = MODEL_TYPES[options.model_type]
        histories = [list(h) for h in ck.histories]
        frozen = list(ck.frozen)
        start_iter = ck.iteration
        lls = np.array([h[-1] if h else -np.inf for h in histories])
        if (options.update_band_every and start_iter > 0
                and not all(frozen)):
            # The band is not checkpointed: re-derive it from the restored
            # best model, so that a resumed run matches an uninterrupted
            # one (exactly when update_band_every == 1).
            jobs = _update_band_jobs(jobs, hmms[int(np.argmax(lls))],
                                     options, device, multi)
            batches = prepare_em_batches(jobs, options.band_width,
                                         options.max_batch_cells, device,
                                         multi)
    else:
        hmms = [_init_trial_hmm(options, input_hmm, t) for t in range(ntr)]
        histories = [[] for _ in range(ntr)]
        frozen = [False] * ntr
        start_iter = 0
        lls = np.full(ntr, -np.inf)

    for it in range(start_iter, options.iterations):
        if all(frozen):
            break
        tc, em, eg, new_ll = expectation_step_trials(batches, hmms, psum_fn)
        for t in range(ntr):
            if frozen[t]:
                continue
            hmms[t] = _m_step(
                hmms[t], tc[t], em[t], eg[t], options.train_emissions
            )
            hmms[t].apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmms[t])
            histories[t].append(float(new_ll[t]))
            if log_fn:
                log_fn("EM trial %d iter %d log-likelihood %.4f"
                       % (t, it, new_ll[t]))
            if np.isfinite(lls[t]) and abs(new_ll[t] - lls[t]) < (
                options.tolerance
            ):
                frozen[t] = True
            lls[t] = new_ll[t]
        if checkpoint_path:
            EmLockstepCheckpoint(
                iteration=it + 1,
                transitions=np.stack([h.transitions for h in hmms]),
                emissions=np.stack([h.emissions for h in hmms]),
                histories=histories,
                frozen=frozen,
            ).save(checkpoint_path)
        if (options.update_band_every
                and (it + 1) % options.update_band_every == 0
                and not all(frozen)):
            # The band follows the best trial's model; every trial's
            # likelihood is over the new band from the next iteration on
            # (a discontinuity the reference's updateTheBand shares).
            jobs = _update_band_jobs(jobs, hmms[int(np.argmax(lls))],
                                     options, device, multi)
            batches = prepare_em_batches(jobs, options.band_width,
                                         options.max_batch_cells, device,
                                         multi)

    best_t = int(np.argmax(lls))
    results = []
    for t in range(ntr):
        hmms[t].likelihood = float(lls[t])
        if options.output_trial_hmms_path:
            hmms[t].write(
                "%s.trial%d" % (options.output_trial_hmms_path, t)
            )
        results.append(EmTrialResult(
            hmm=hmms[t], likelihood=float(lls[t]),
            likelihood_history=histories[t],
        ))
    return results[best_t]


def _refuse_unported() -> None:
    dist = torch.distributed
    if (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise NotImplementedError(
            "EM training sharded over several processes is not ported yet "
            "(slice 5 of the port); train in one process"
        )


def train_em(
    jobs: List[RealignJob],
    options: EmOptions,
    input_hmm: Optional[PairHmm] = None,
    psum_fn=None,
    log_fn=None,
    checkpoint_path: Optional[str] = None,
    device="cuda",
    multi: bool = False,
) -> EmTrialResult:
    """Run the full multi-trial EM on `device` and return the best trial.

    With checkpoint_path, state is saved after every iteration and training
    resumes mid-trial from an existing checkpoint file (the jobTree-resume
    equivalent; see align/checkpoint.py).  multi=True: E-step batches of
    multi-problem lanes (module docstring), after every band update too."""
    from .checkpoint import EmCheckpoint, is_lockstep_checkpoint

    _refuse_unported()
    jobs = sample_jobs(jobs, options.max_alignment_length_to_sample,
                       options.seed)

    # Anchor splitting (reference EM realign options
    # --splitMatrixBiggerThanThis=300, src/margin/marginAlign.py:41):
    # long alignments decompose at guide anchors into independent DP
    # sub-problems; expected counts sum over segments and the trial
    # likelihood is the sum of segment logZs.
    if options.split_size and options.split_size > 0:
        from .realign import split_jobs_at_anchors

        jobs, _, _ = split_jobs_at_anchors(jobs, options.split_size)
    batches = prepare_em_batches(jobs, options.band_width,
                                 options.max_batch_cells, device, multi)

    # Lockstep trials unless resuming an old serial-format checkpoint.
    serial_resume = (
        checkpoint_path
        and EmCheckpoint.try_load(checkpoint_path) is not None
        and not is_lockstep_checkpoint(checkpoint_path)
    )
    if options.lockstep and options.trials > 1 and not serial_resume:
        return _train_em_lockstep(
            batches, options, input_hmm, psum_fn, log_fn, checkpoint_path,
            jobs, device, multi,
        )

    ckpt = EmCheckpoint.try_load(checkpoint_path)
    start_trial = ckpt.trial if ckpt else 0
    best: Optional[EmTrialResult] = None
    if ckpt and ckpt.best_hmm() is not None:
        bh = ckpt.best_hmm()
        best = EmTrialResult(hmm=bh, likelihood=bh.likelihood,
                             likelihood_history=[])

    for trial in range(start_trial, options.trials):
        if ckpt and trial == ckpt.trial:
            hmm = ckpt.hmm()
            history = list(ckpt.likelihood_history)
            start_iter = ckpt.iteration
            ll = history[-1] if history else -np.inf
            hmm.model_type = MODEL_TYPES[options.model_type]
            hmm.apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmm)
        else:
            hmm = _init_trial_hmm(options, input_hmm, trial)
            history = []
            start_iter = 0
            ll = -np.inf
        # Each serial trial starts from the original guide band; its band
        # updates (update_band_every) stay its own.
        trial_jobs, trial_batches = jobs, batches
        for it in range(start_iter, options.iterations):
            tc, em, eg, new_ll = expectation_step(trial_batches, hmm,
                                                  psum_fn)
            hmm = _m_step(hmm, tc, em, eg, options.train_emissions)
            hmm.apply_model_type_constraints()
            if options.tie_emissions:
                _tie_gap_emissions(hmm)
            history.append(new_ll)
            if log_fn:
                log_fn("EM trial %d iter %d log-likelihood %.4f"
                       % (trial, it, new_ll))
            if checkpoint_path:
                EmCheckpoint(
                    trial=trial, iteration=it + 1,
                    transitions=hmm.transitions, emissions=hmm.emissions,
                    likelihood_history=history,
                    best_trial_likelihood=(
                        best.likelihood if best else -np.inf
                    ),
                    best_transitions=(
                        best.hmm.transitions if best else None
                    ),
                    best_emissions=best.hmm.emissions if best else None,
                ).save(checkpoint_path)
            if np.isfinite(ll) and abs(new_ll - ll) < options.tolerance:
                ll = new_ll
                break
            ll = new_ll
            if (options.update_band_every
                    and (it + 1) % options.update_band_every == 0):
                trial_jobs = _update_band_jobs(trial_jobs, hmm, options,
                                               device, multi)
                trial_batches = prepare_em_batches(
                    trial_jobs, options.band_width, options.max_batch_cells,
                    device, multi)
        hmm.likelihood = ll
        if options.output_trial_hmms_path:
            hmm.write("%s.trial%d" % (options.output_trial_hmms_path, trial))
        result = EmTrialResult(hmm=hmm, likelihood=ll,
                               likelihood_history=history)
        if best is None or result.likelihood > best.likelihood:
            best = result
        if checkpoint_path:
            # Mark this trial complete: next trial starts fresh on resume.
            EmCheckpoint(
                trial=trial + 1, iteration=0,
                transitions=hmm.transitions, emissions=hmm.emissions,
                likelihood_history=[],
                best_trial_likelihood=best.likelihood,
                best_transitions=best.hmm.transitions,
                best_emissions=best.hmm.emissions,
            ).save(checkpoint_path)
    assert best is not None
    return best


def normalise_trained_hmm(hmm: PairHmm) -> PairHmm:
    """Post-EM normalisation: flat indel emissions + GC 0.5 renormalisation
    (reference: learnModelFromSamFileTargetFn2, marginAlignLib.py:227-232)."""
    out = hmm.copy()
    out.set_flat_indel_emissions()
    out.normalise_by_gc_content(0.5)
    return out
