"""EaCO's measurement history H (``history``) and PredictJCT
(``predictor``): copies of the JAX package's pure-Python modules. The
schedulers are not ported yet."""
