"""Generation-step factories of the port (``repro.train``); training
itself comes with a later slice."""
