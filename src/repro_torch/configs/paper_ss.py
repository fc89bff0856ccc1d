"""The paper's own workload configuration (§4 of the paper): the port's
copy of ``repro/configs/paper_ss.py``, with identical fields and defaults.

Submodular sparsification hyperparameters and the synthetic-corpus stand-ins
for the NYT / DUC2001 / SumMe experiments.  These defaults follow the paper:
r = 8, c = 8 (shrink rate 1/sqrt(8) ≈ 0.354, i.e. ~64.6% pruned per round),
k = 10 for the utility study, 50 sieve thresholds, feature-based
sqrt-coverage objective.  ``examples/video_summarize_torch.py`` reads ``r``,
``c`` and ``summary_frac`` from ``DEFAULT``.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class SSWorkload:
    r: int = 8                 # probe multiplier (paper: r = 8)
    c: float = 8.0             # accuracy/speed tradeoff (paper: c = 8)
    k: int = 10                # summary budget for the utility study
    sieve_thresholds: int = 50  # paper: "50 trials" -> memory 50k
    phi: str = "sqrt"          # concave transform of the coverage objective

    # synthetic NYT-like news corpus (per "day")
    news_days: int = 64            # scaled-down stand-in for 3823 days
    news_sentences: tuple = (1000, 20000)   # n range per day
    news_features: int = 1024      # hashed-TFIDF feature dim
    news_zipf: float = 1.07        # token Zipf exponent

    # synthetic SumMe-like video corpus
    video_count: int = 25
    video_frames: tuple = (950, 9721)
    video_features: int = 512      # pHoG/GIST-like descriptor dim
    summary_frac: float = 0.15     # k = 0.15 |V| (paper §5.13)


DEFAULT = SSWorkload()
