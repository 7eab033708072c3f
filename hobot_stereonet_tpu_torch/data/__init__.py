"""Data sources of the port: the procedural scene generator, the dataset
adapter the evaluation reads, and the camera stream sources."""
