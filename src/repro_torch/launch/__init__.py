"""The LM dry run on one card: each (arch x shape) cell's step traced on
fake tensors, its FLOPs, HBM bytes and peak memory counted from the port's
own graph, and an H100 roofline (`roofline`, `dryrun`, `hillclimb`); the
reference's production meshes as abstract grids (`mesh`). Counterpart of
`repro.launch`."""
