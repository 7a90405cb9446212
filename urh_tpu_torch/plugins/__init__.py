"""Plugin base classes (the part of urh_tpu.plugins that the device layer
needs: the Network SDR is an ``SDRPlugin``)."""
