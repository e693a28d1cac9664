"""One driver per kind of traffic, named by a mix's ``kind``."""
