"""Multi-device scale-out: the batch split over a list of devices
(``mesh``) and file sharding over hosts (``multihost``)."""
