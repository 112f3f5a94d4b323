"""The paper's primary contribution, as pluggable schedulers: EaCO
(Algorithm 1/2) and its variants (EaCO-Occ, EaCO-Elastic, EaCO-PowerCap),
the three paper baselines, and the shared admission machinery
(FindCandidates, PredictJCT, the measurement history H).  See
``docs/schedulers.md`` for the policy-by-policy map."""
