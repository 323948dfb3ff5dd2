"""Step builders (`steps`) and the slot-based serving loop (`serve`) of
the port, for dense GQA decoders on one GPU."""
