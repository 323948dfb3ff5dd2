"""Step builders (`steps`), the slot-based serving loop (`serve`) and the
fake-tensor dry-run of a serving step (`dryrun`) of the port, on one
GPU."""
