"""The census: the work of one frame of each network, from its layer shapes."""
