"""Device-resident data-plane structures (``columns.DeviceColumnPlane``)."""
