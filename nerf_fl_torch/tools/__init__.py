"""The port's offline tools, each runnable as ``python -m
nerf_fl_torch.tools.<name>``: the quality gate, the scale stress, the
fixture and tsv generators, the checkpoint stripper and the trace
summary."""
