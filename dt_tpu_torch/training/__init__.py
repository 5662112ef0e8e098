"""Training-side modules of the port; this slice has the checkpoint reader."""
