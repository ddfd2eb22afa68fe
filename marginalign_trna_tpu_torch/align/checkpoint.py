"""EM training checkpoint/resume.

A copy of marginalign_trna_tpu/align/checkpoint.py (numpy only), so the
port runs without the JAX package; the file format is the same, so either
package resumes the other's checkpoints.

The reference's durability story is the jobTree job-store directory (resume
an interrupted run) plus per-trial HMM files (outputTrialHmms,
src/margin/marginAlign.py:44).  Here the unit of recovery is the EM
iteration: after every iteration the trial index, iteration number,
likelihood history and current model parameters are written atomically to a
single .npz; training resumes mid-trial from it.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..models.hmm import PairHmm


@dataclass
class EmCheckpoint:
    trial: int
    iteration: int
    transitions: np.ndarray
    emissions: np.ndarray
    likelihood_history: List[float] = field(default_factory=list)
    best_trial_likelihood: float = -np.inf
    best_transitions: Optional[np.ndarray] = None
    best_emissions: Optional[np.ndarray] = None

    def hmm(self) -> PairHmm:
        return PairHmm(self.transitions.copy(), self.emissions.copy())

    def best_hmm(self) -> Optional[PairHmm]:
        if self.best_transitions is None:
            return None
        h = PairHmm(self.best_transitions.copy(), self.best_emissions.copy())
        h.likelihood = self.best_trial_likelihood
        return h

    def save(self, path: str) -> None:
        """Atomic write (tmp + rename) so a crash never corrupts it."""
        tmp_fd, tmp_path = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".",
            suffix=".ckpt.tmp",
        )
        os.close(tmp_fd)
        try:
            with open(tmp_path, "wb") as fh:
                np.savez(
                    fh,
                    trial=self.trial,
                    iteration=self.iteration,
                    transitions=self.transitions,
                    emissions=self.emissions,
                    likelihood_history=np.asarray(
                        self.likelihood_history, dtype=np.float64
                    ),
                    best_trial_likelihood=self.best_trial_likelihood,
                    best_transitions=(
                        self.best_transitions
                        if self.best_transitions is not None
                        else np.zeros((0,))
                    ),
                    best_emissions=(
                        self.best_emissions
                        if self.best_emissions is not None
                        else np.zeros((0,))
                    ),
                )
            os.replace(tmp_path, path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)

    @staticmethod
    def load(path: str) -> "EmCheckpoint":
        with np.load(path) as z:
            best_t = z["best_transitions"]
            best_e = z["best_emissions"]
            return EmCheckpoint(
                trial=int(z["trial"]),
                iteration=int(z["iteration"]),
                transitions=z["transitions"],
                emissions=z["emissions"],
                likelihood_history=list(z["likelihood_history"]),
                best_trial_likelihood=float(z["best_trial_likelihood"]),
                best_transitions=best_t if best_t.size else None,
                best_emissions=best_e if best_e.size else None,
            )

    @staticmethod
    def try_load(path: Optional[str]) -> Optional["EmCheckpoint"]:
        if path and os.path.exists(path):
            with np.load(path) as z:
                if "lockstep" in z.files:
                    return None  # lockstep-format file; not ours
            return EmCheckpoint.load(path)
        return None


@dataclass
class EmLockstepCheckpoint:
    """Checkpoint for lockstep-trials EM (all trials advance together, one
    device call per E-step batch per iteration): iteration-major state with
    every trial's parameters, history and frozen flag."""

    iteration: int
    transitions: np.ndarray        # [Ntr, 5, 5]
    emissions: np.ndarray          # [Ntr, 5, 16]
    histories: List[List[float]] = field(default_factory=list)
    frozen: List[bool] = field(default_factory=list)

    def hmms(self) -> List[PairHmm]:
        return [
            PairHmm(self.transitions[t].copy(), self.emissions[t].copy())
            for t in range(self.transitions.shape[0])
        ]

    def save(self, path: str) -> None:
        tmp_fd, tmp_path = tempfile.mkstemp(
            dir=os.path.dirname(os.path.abspath(path)) or ".",
            suffix=".ckpt.tmp",
        )
        os.close(tmp_fd)
        ntr = self.transitions.shape[0]
        hl = max([len(h) for h in self.histories] + [1])
        hist = np.full((ntr, hl), np.nan)
        for t, h in enumerate(self.histories):
            hist[t, : len(h)] = h
        try:
            with open(tmp_path, "wb") as fh:
                np.savez(
                    fh,
                    lockstep=1,
                    iteration=self.iteration,
                    transitions=self.transitions,
                    emissions=self.emissions,
                    histories=hist,
                    frozen=np.asarray(self.frozen, dtype=np.int8),
                )
            os.replace(tmp_path, path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)

    @staticmethod
    def try_load(path: Optional[str]) -> Optional["EmLockstepCheckpoint"]:
        if not (path and os.path.exists(path)):
            return None
        with np.load(path) as z:
            if "lockstep" not in z.files:
                return None
            hist = z["histories"]
            histories = [
                [float(v) for v in row[~np.isnan(row)]] for row in hist
            ]
            return EmLockstepCheckpoint(
                iteration=int(z["iteration"]),
                transitions=z["transitions"],
                emissions=z["emissions"],
                histories=histories,
                frozen=[bool(v) for v in z["frozen"]],
            )


def is_lockstep_checkpoint(path: Optional[str]) -> bool:
    if not (path and os.path.exists(path)):
        return False
    with np.load(path) as z:
        return "lockstep" in z.files
