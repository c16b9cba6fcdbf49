"""Named parameter presets: the reference's published configurations (the
port's copy of `mapquik_tpu.models.presets`).

Each preset reproduces a configuration used by the reference paper/repo
(sources: src/main.rs:174-188 defaults; example/run_ecoli.sh:27 E. coli run;
experiments/table1.sh:12,50 human CHM13/HG002 runs), with capacity knobs
derived via Params.auto so no seed cap can clip at that density.

Usage:
    from mapquik_tpu_torch.models import presets
    p = presets.human()          # k=7 l=31 d=0.01 (table1 headline config)
    p = presets.ecoli()          # k=8 l=16 d=0.01 g=100 (bundled example)
    p = presets.default()        # reference CLI defaults (k=5 l=31 d=0.01)
"""

from __future__ import annotations

from ..params import Params


def default(**overrides) -> Params:
    """Reference CLI defaults: k=5 l=31 d=0.01 c=4 s=11 g=2000 (src/main.rs:174-188)."""
    return Params.auto(**overrides)


def human(**overrides) -> Params:
    """CHM13 / HG002 HiFi headline config: k=7 l=31 d=0.01
    (experiments/table1.sh:12,50)."""
    return Params.auto(**{"k": 7, "l": 31, "density": 0.01, **overrides})


def ecoli(**overrides) -> Params:
    """Bundled E. coli acceptance-test config: k=8 l=16 d=0.01 g=100
    (example/run_ecoli.sh:27)."""
    return Params.auto(**{"k": 8, "l": 16, "density": 0.01, "g": 100, **overrides})


def maize(**overrides) -> Params:
    """Repeat-rich genome config — same knobs as human; the unique-seed filter is
    the repeat-masking strategy (SURVEY.md §2.3), no parameter change needed
    (experiments/simulate_maize.sh)."""
    return human(**overrides)


PRESETS = {"default": default, "human": human, "ecoli": ecoli, "maize": maize}
