"""Models: TrackNet (channels-last) and the weight bridges."""
