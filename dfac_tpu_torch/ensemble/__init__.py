"""Score ensembles: checkpoint means and the hybrid CNN + CAE fusion."""
