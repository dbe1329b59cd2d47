"""One driver per kind of traffic, named by the traffic file's ``driver``."""
