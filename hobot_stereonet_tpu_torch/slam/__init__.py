"""The SLAM back end of the port: SE(3), features, odometry, bundle
adjustment, the pose graph and the tracker (``hobot_stereonet_tpu/slam``)."""
