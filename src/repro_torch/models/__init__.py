"""Language models of the port (`repro.models`)."""
