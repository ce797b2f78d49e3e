"""Model code of the port: so far only the Mamba-2 chunked SSD scan
(``ssm._ssd_chunked``), the oracle of the SSD chunk kernel."""
