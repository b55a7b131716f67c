"""Training-side modules of the port: the checkpoint format
(`checkpoint`, which the fleet's fault tolerance shares), AdamW and the
paper's schedules (`optimizer`) and QAT training of the keyword
classifier (`kws`, ``python -m repro_torch.training.kws``)."""
