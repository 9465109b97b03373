"""Model assembly of the port: layers, attention, the decoder LM."""
