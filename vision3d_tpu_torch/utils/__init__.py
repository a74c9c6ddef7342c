"""Host utilities: the BEV image (``bev_drawer``) and the native host
library (``native``)."""
