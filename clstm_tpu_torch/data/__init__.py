"""Line preparation and width buckets."""
