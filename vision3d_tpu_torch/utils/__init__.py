"""Host utilities: the BEV image (``bev_drawer``)."""
