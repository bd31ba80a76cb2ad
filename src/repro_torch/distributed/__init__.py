"""Distribution for the port (``repro/distributed``): so far the lossy
array codecs the field uplink uses (:mod:`.compression`)."""
