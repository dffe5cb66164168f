"""Data: the PNG codec and image-file entry points (``png``), host
preprocessing (``native``), pair datasets and the batch loader
(``datasets``), degradations on the card (``degradations``), the
synthetic pair loader (``synthetic``) and the offline pair factory's host
degradations (``host_degradations``)."""
