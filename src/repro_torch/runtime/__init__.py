"""Runtime services of the port: transient-failure retry (``retry``)."""
