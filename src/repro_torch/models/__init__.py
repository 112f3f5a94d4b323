"""Model code of the port: parameters, layers, the decoder-only LM."""
