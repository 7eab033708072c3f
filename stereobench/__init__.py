"""The benchmark of ``hobot_stereonet_tpu_torch`` on NVIDIA GPUs (``run.py``)."""
