"""The cluster layer's job model (``job``), the paper's power tables
(``power``) and the co-location dynamics (``colocation``): copies of the JAX
package's pure-Python modules, for EaCO's history and JCT predictor. The
rest of the layer (nodes, fleet, traces, the simulator) is not ported yet."""
