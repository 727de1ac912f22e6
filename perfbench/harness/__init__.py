"""What every cell shares: the spec lookup, the run record, the profiled
stretch, the training check and the result line."""
