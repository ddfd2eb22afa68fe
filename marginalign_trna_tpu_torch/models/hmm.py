"""Five-state pair-HMM model: parameters, text codec, and model surgery.

State semantics (matching the cPecan fiveState model as used by the
reference; see SURVEY.md §2 and src/margin/marginAlignLib.py:238-263):

  state 0 : match        — emits (ref base x, read base y), advances both
  state 1 : short gap X  — emits a reference base only (deletion in read)
  state 2 : short gap Y  — emits a read base only (insertion in read)
  state 3 : long gap X   — as 1, for long deletions
  state 4 : long gap Y   — as 2, for long insertions

The reference's GC-content normalisation skips states 2 and 4 as "insert
states (no ref bases)" (marginAlignLib.py:241-242), which fixes this
interpretation.

Text format (identical to the reference model files, e.g.
src/margin/mappers/last_hmm_20.txt):
  line 1: modelType int, then 25 row-stochastic transitions (from*5+to),
          then the final training log-likelihood
  line 2: 80 emission probabilities, 5 states x 16 (ref_base*4 + read_base)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

SYMBOL_NUMBER = 4
STATE_NUMBER = 5

MODEL_TYPES = {
    "fiveState": 0,
    "fiveStateAsymmetric": 1,
    "threeState": 2,
    "threeStateAsymmetric": 3,
}

MATCH_STATE = 0
GAP_X_STATES = (1, 3)  # advance reference only (deletions in the read)
GAP_Y_STATES = (2, 4)  # advance read only (insertions in the read)


@dataclass
class PairHmm:
    """Parameters of the 5-state pair-HMM.

    transitions: [5, 5] float64, row-stochastic, transitions[from, to]
    emissions:   [5, 16] float64, emissions[state, ref_base*4 + read_base]
    """

    transitions: np.ndarray
    emissions: np.ndarray
    likelihood: float = 0.0
    model_type: int = 1  # fiveStateAsymmetric

    state_number: int = field(default=STATE_NUMBER, init=False)

    def __post_init__(self):
        self.transitions = np.asarray(self.transitions, dtype=np.float64).reshape(
            STATE_NUMBER, STATE_NUMBER
        )
        self.emissions = np.asarray(self.emissions, dtype=np.float64).reshape(
            STATE_NUMBER, SYMBOL_NUMBER * SYMBOL_NUMBER
        )

    # ------------------------------------------------------------------ codec

    @property
    def native_state_number(self) -> int:
        """States in the on-disk representation: 3 for the threeState model
        types, 5 otherwise.  Internally everything is 5-state; for 3-state
        models states 3 and 4 are inert (self-loop 1, unreachable)."""
        return 3 if self.model_type in (2, 3) else STATE_NUMBER

    @staticmethod
    def load(path: str) -> "PairHmm":
        """Parse the reference text format (3- or 5-state), with the same
        internal consistency checks as the reference Hmm.loadHmm (rows ~sum
        to 1).  Three-state models expand to the internal 5-state form with
        inert long-gap states."""
        with open(path) as fh:
            line1 = fh.readline().split()
            line2 = fh.readline().split()
        n_tokens = len(line1) - 2
        state_number = int(round(n_tokens ** 0.5))
        assert state_number * state_number == n_tokens and state_number in (3, 5), (
            "Bad HMM transitions line in %s" % path
        )
        model_type = int(line1[0])
        native_t = np.array(line1[1:-1], dtype=np.float64).reshape(
            state_number, state_number
        )
        likelihood = float(line1[-1])
        assert len(line2) == state_number * SYMBOL_NUMBER**2, (
            "Bad HMM emissions line in %s" % path
        )
        native_e = np.array(line2, dtype=np.float64).reshape(
            state_number, SYMBOL_NUMBER**2
        )
        if state_number == 3:
            transitions = np.zeros((STATE_NUMBER, STATE_NUMBER))
            transitions[:3, :3] = native_t
            transitions[3, 3] = 1.0
            transitions[4, 4] = 1.0
            emissions = np.full(
                (STATE_NUMBER, SYMBOL_NUMBER**2), 1.0 / SYMBOL_NUMBER**2
            )
            emissions[:3] = native_e
        else:
            transitions, emissions = native_t, native_e
        hmm = PairHmm(transitions, emissions, likelihood, model_type)
        hmm.check()
        return hmm

    def write(self, path: str) -> None:
        n = self.native_state_number
        with open(path, "w") as fh:
            tokens = [str(self.model_type)]
            tokens += [
                repr(float(x)) for x in self.transitions[:n, :n].reshape(-1)
            ]
            tokens.append(repr(float(self.likelihood)))
            fh.write(" ".join(tokens) + "\n")
            fh.write(
                " ".join(
                    repr(float(x)) for x in self.emissions[:n].reshape(-1)
                ) + "\n"
            )

    def check(self, tol: float = 1e-5) -> None:
        trans_rows = self.transitions.sum(axis=1)
        assert np.all(np.abs(trans_rows - 1.0) < tol), (
            "HMM transition rows not stochastic: %s" % trans_rows
        )
        emis_rows = self.emissions.sum(axis=1)
        assert np.all(np.abs(emis_rows - 1.0) < tol), (
            "HMM emission rows not normalised: %s" % emis_rows
        )

    def copy(self) -> "PairHmm":
        return PairHmm(
            self.transitions.copy(), self.emissions.copy(),
            self.likelihood, self.model_type,
        )

    # ------------------------------------------------- derived kernel tables

    def match_emissions_5x5(self) -> np.ndarray:
        """[5, 5] match emission table over codes {A,C,G,T,N}; the N
        row/column is the mean over real bases (wildcard semantics)."""
        e = self.emissions[MATCH_STATE].reshape(SYMBOL_NUMBER, SYMBOL_NUMBER)
        out = np.zeros((5, 5), dtype=np.float64)
        out[:4, :4] = e
        out[4, :4] = e.mean(axis=0)
        out[:4, 4] = e.mean(axis=1)
        out[4, 4] = e.mean()
        return out

    def gap_emissions_5(self) -> np.ndarray:
        """[5 states, 5 codes] single-base emission marginals for the gap
        states (row 0 is unused for the match state).  X-gap states emit a
        reference base (sum over read base); Y-gap states emit a read base
        (sum over ref base).  Code 4 (N) is the mean over real bases."""
        out = np.zeros((STATE_NUMBER, 5), dtype=np.float64)
        for s in range(1, STATE_NUMBER):
            e = self.emissions[s].reshape(SYMBOL_NUMBER, SYMBOL_NUMBER)
            marg = e.sum(axis=1) if s in GAP_X_STATES else e.sum(axis=0)
            out[s, :4] = marg
            out[s, 4] = marg.mean()
        return out

    def substitution_matrix(self) -> np.ndarray:
        """Row-normalised 4x4 match emissions: P(read base | true base), used
        as the caller error model (reference: loadHmmSubstitutionMatrix,
        src/margin/marginCallerLib.py:93-99)."""
        e = self.emissions[MATCH_STATE].reshape(SYMBOL_NUMBER, SYMBOL_NUMBER)
        return e / e.sum(axis=1, keepdims=True)

    # ------------------------------------------------------------- surgery

    def set_flat_indel_emissions(self) -> None:
        """Set all non-match emissions to 1/16
        (reference: setHmmIndelEmissionsToBeFlat, marginAlignLib.py:251-256)."""
        self.emissions[1:, :] = 1.0 / SYMBOL_NUMBER**2

    def normalise_by_gc_content(self, gc_content: float) -> None:
        """Renormalise ref-base background frequencies of the ref-emitting
        states (all but the insert states 2 and 4) to the given GC fraction
        (reference: normaliseHmmByReferenceGCContent, marginAlignLib.py:238-249).
        Base order is A,C,G,T; rows 1 (C) and 2 (G) get gc/2, rows 0 and 3
        get (1-gc)/2."""
        row_weight = np.array(
            [
                (1.0 - gc_content) / 2.0,
                gc_content / 2.0,
                gc_content / 2.0,
                (1.0 - gc_content) / 2.0,
            ]
        )
        for s in range(STATE_NUMBER):
            if s in GAP_Y_STATES:
                continue
            e = self.emissions[s].reshape(SYMBOL_NUMBER, SYMBOL_NUMBER)
            e = e / e.sum(axis=1, keepdims=True) * row_weight[:, None]
            self.emissions[s] = e.reshape(-1)

    def modify_by_substitution_rate(self, substitution_rate: float) -> None:
        """Relax the match emissions by an expected variation rate: multiply
        by a Jukes-Cantor-style matrix with (1-r) on the diagonal and r/3 off
        it (reference: modifyHmmEmissionsByExpectedVariationRate,
        marginAlignLib.py:258-263)."""
        r = substitution_rate
        n = np.full((SYMBOL_NUMBER, SYMBOL_NUMBER), r / (SYMBOL_NUMBER - 1))
        np.fill_diagonal(n, 1.0 - r)
        e = self.emissions[MATCH_STATE].reshape(SYMBOL_NUMBER, SYMBOL_NUMBER)
        self.emissions[MATCH_STATE] = (e @ n).reshape(-1)

    def write_xml(self, path: str) -> None:
        """XML model dump (reference surface: cPecanEm outputXMLModelFile,
        marginAlign.py:48)."""
        import xml.etree.ElementTree as ET

        root = ET.Element("hmm", {
            "type": str(self.model_type),
            "stateNumber": str(self.native_state_number),
            "likelihood": repr(float(self.likelihood)),
        })
        t = ET.SubElement(root, "transitions")
        n = self.native_state_number
        for a in range(n):
            for b in range(n):
                ET.SubElement(t, "t", {
                    "from": str(a), "to": str(b),
                    "prob": repr(float(self.transitions[a, b])),
                })
        e = ET.SubElement(root, "emissions")
        for s in range(n):
            ET.SubElement(e, "state", {
                "id": str(s),
                "probs": " ".join(repr(float(v)) for v in self.emissions[s]),
            })
        ET.ElementTree(root).write(path)

    def apply_model_type_constraints(self) -> None:
        """Project the parameters onto the model family's constraint set
        (reference: cPecanEm modelType in {fiveState, fiveStateAsymmetric,
        threeState, threeStateAsymmetric}; src/margin/marginAlign.py:40).

        - threeState*: no long-gap states — mass into states 3/4 is removed
          (rows renormalised) and they become inert self-loops;
        - symmetric families (fiveState, threeState): parameters tied under
          the X<->Y swap (1<->2, 3<->4; emissions transpose).
        """
        if self.model_type in (2, 3):  # three-state families
            t = self.transitions
            t[:3, 3:] = 0.0
            t[3:, :] = 0.0
            t[3, 3] = 1.0
            t[4, 4] = 1.0
            rows = t[:3].sum(axis=1, keepdims=True)
            t[:3] = np.where(rows > 0, t[:3] / np.maximum(rows, 1e-30),
                             t[:3])
            self.emissions[3:] = 1.0 / SYMBOL_NUMBER**2
        if self.model_type in (0, 2):  # symmetric families
            swap = [0, 2, 1, 4, 3]
            t_sym = 0.5 * (
                self.transitions + self.transitions[swap][:, swap]
            )
            self.transitions = t_sym
            e = self.emissions.reshape(
                STATE_NUMBER, SYMBOL_NUMBER, SYMBOL_NUMBER
            )
            e_swapped = e[swap].transpose(0, 2, 1)
            self.emissions = (0.5 * (e + e_swapped)).reshape(
                STATE_NUMBER, SYMBOL_NUMBER**2
            )
            if self.model_type == 2:
                self.emissions[3:] = 1.0 / SYMBOL_NUMBER**2

    # --------------------------------------------------------- constructors

    @staticmethod
    def random(seed: int, concentration: float = 1.0) -> "PairHmm":
        """Random row-stochastic start model for EM trials (the reference's
        randomStart=True behaviour, src/margin/marginAlign.py:42)."""
        rng = np.random.default_rng(seed)
        transitions = rng.gamma(concentration, size=(STATE_NUMBER, STATE_NUMBER))
        transitions /= transitions.sum(axis=1, keepdims=True)
        emissions = rng.gamma(concentration, size=(STATE_NUMBER, SYMBOL_NUMBER**2))
        emissions /= emissions.sum(axis=1, keepdims=True)
        return PairHmm(transitions, emissions, 0.0, 1)

    @staticmethod
    def uniform() -> "PairHmm":
        transitions = np.full((STATE_NUMBER, STATE_NUMBER), 1.0 / STATE_NUMBER)
        emissions = np.full(
            (STATE_NUMBER, SYMBOL_NUMBER**2), 1.0 / SYMBOL_NUMBER**2
        )
        return PairHmm(transitions, emissions, 0.0, 1)
