"""Step builders (`steps`), the training loop (`train`), the slot-based
serving loop (`serve`) and the fake-tensor dry-run of a step (`dryrun`)
of the port, on one GPU."""
