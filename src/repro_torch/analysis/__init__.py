"""Work counts of a step (`counts`) and their roofline on the H100
(`roofline`)."""
