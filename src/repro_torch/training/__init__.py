"""Training-side modules of the port; so far the checkpoint format
(`checkpoint`), which the fleet's fault tolerance shares."""
