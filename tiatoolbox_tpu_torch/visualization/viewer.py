"""Self-contained HTML slide viewer (counterpart of ``tiatoolbox_tpu/visualization/viewer.py``).

The page is JAX's, copied: a vanilla JS pan/zoom canvas that pulls Zoomify
tiles from the port's ``TileServer``, with layer toggles, opacity control,
tap-to-query of annotation properties, split view, colour and filter
controls, property statistics, segment-on-box, SAM prompts, graph overlays
and multichannel controls. Only the package name in the default title
changes.
"""

from __future__ import annotations

VIEWER_HTML = """<!DOCTYPE html>
<html>
<head>
<meta charset="utf-8"/>
<title>{title}</title>
<style>
  body {{ margin: 0; font-family: sans-serif; background: #222; color: #eee; }}
  #toolbar {{ padding: 8px; background: #333; display: flex; gap: 12px;
             align-items: center; flex-wrap: wrap; }}
  #view {{ position: relative; overflow: hidden; width: 100vw;
          height: calc(100vh - 48px); cursor: grab; }}
  canvas {{ position: absolute; top: 0; left: 0; }}
  #info {{ position: absolute; bottom: 8px; left: 8px; background:
          rgba(0,0,0,.7); padding: 6px 10px; border-radius: 4px;
          font-size: 12px; max-width: 40em; white-space: pre-wrap; }}
  label {{ font-size: 13px; }}
</style>
</head>
<body>
<div id="toolbar">
  <strong>{title}</strong>
  <span id="layers"></span>
  <label>overlay opacity
    <input id="alpha" type="range" min="0" max="1" step="0.05" value="0.7"/>
  </label>
  <input id="ovpath" type="text" placeholder="overlay path (.db/.geojson/img)"
         size="28"/>
  <button id="ovload">load overlay</button>
  <input id="slide2" type="text" placeholder="second slide path" size="22"/>
  <button id="split">split view</button>
  <label>colour by <select id="colorprop"><option value="">type</option>
  </select></label>
  <label>cmap <select id="cmap">
    <option>viridis</option><option>jet</option><option>coolwarm</option>
    <option>plasma</option><option>inferno</option>
  </select></label>
  <button id="filterbtn">filter</button>
  <button id="statsbtn">stats</button>
  <button id="segbox">segment box</button>
  <button id="sammode">SAM points</button>
  <button id="samrun" style="display:none;">run SAM</button>
  <input id="graphpath" type="text" placeholder="graph path (.json/.npz)"
         size="22"/>
  <button id="graphload">load graph</button>
  <button id="chanbtn" style="display:none;">channels</button>
  <span id="pos"></span>
</div>
<div id="chanpanel" style="display:none; padding:8px; background:#2a2a2a;">
  <div id="chanrows" style="display:flex; gap:14px; flex-wrap:wrap;"></div>
  <button id="chanall">select all</button>
  <button id="channone">deselect all</button>
  <button id="chanapply">apply</button>
  <label>enhance
    <input id="enhance" type="range" min="0.1" max="10" step="0.1" value="1"/>
  </label>
  <span id="enhanceval">1.0</span>
</div>
<div id="filterpanel" style="display:none; padding:8px; background:#2a2a2a;">
  <div id="filterrows"></div>
  <button id="addrow">+ condition</button>
  <button id="applyfilter">apply</button>
  <button id="clearfilter">clear</button>
  <code id="filterpreview" style="margin-left:12px; color:#9c9;"></code>
</div>
<div id="statspanel" style="display:none; padding:8px; background:#2a2a2a;">
  <label>property <select id="statprop"></select></label>
  <span id="statsummary"></span>
  <canvas id="histcanvas" width="420" height="90"
          style="position:static; background:#1a1a1a; margin-left:10px;"></canvas>
</div>
<div id="view"><canvas id="canvas"></canvas><div id="info"></div></div>
<script>
const TILE = 256;
let layers = [];
let visible = {{}};
let meta = null;
let scale = 0.1, ox = 0, oy = 0;  // world→screen: s = world*scale + o
let alpha = 0.7;
const canvas = document.getElementById('canvas');
const ctx = canvas.getContext('2d');
const view = document.getElementById('view');
const tileCache = new Map();

async function init() {{
  const resp = await fetch('/tileserver/layers');
  layers = (await resp.json()).layers;
  const span = document.getElementById('layers');
  for (const name of layers) {{
    visible[name] = true;
    const lbl = document.createElement('label');
    const cb = document.createElement('input');
    cb.type = 'checkbox'; cb.checked = true;
    cb.onchange = () => {{ visible[name] = cb.checked; draw(); }};
    lbl.appendChild(cb); lbl.appendChild(document.createTextNode(name));
    span.appendChild(lbl);
  }}
  const infoResp = await fetch('/tileserver/info/' + layers[0]);
  meta = await infoResp.json();
  resize();
  const [w, h] = meta.slide_dimensions;
  scale = Math.min(canvas.width / w, canvas.height / h);
  draw();
  initChannels();
}}

function resize() {{
  canvas.width = view.clientWidth;
  canvas.height = view.clientHeight;
}}

function levelForScale(s) {{
  const [w, h] = meta.slide_dimensions;
  const nLevels = Math.ceil(Math.log2(Math.max(w, h) / TILE)) + 1;
  // level L renders slide at 2^(nLevels-1-L) downsample
  let lvl = nLevels - 1 + Math.ceil(Math.log2(Math.min(s, 1)));
  return [Math.max(0, Math.min(nLevels - 1, lvl)), nLevels];
}}

let auxSession = null;  // second (split-view) slide session id

function tileURL(layer, z, x, y, session) {{
  const s = session || 'default';
  return `/tileserver/layer/${{layer}}/${{s}}/zoomify/TileGroup0/${{z}}-${{x}}-${{y}}.jpg`;
}}

function getTile(layer, z, x, y, session) {{
  const key = `${{session || 'default'}}/${{layer}}/${{z}}/${{x}}/${{y}}`;
  if (tileCache.has(key)) return tileCache.get(key);
  const img = new Image();
  img.onload = draw;
  img.src = tileURL(layer, z, x, y, session);
  tileCache.set(key, img);
  if (tileCache.size > 600) tileCache.delete(tileCache.keys().next().value);
  return img;
}}

function drawPane(clipX, clipW, paneLayers, session, paneOx) {{
  ctx.save();
  ctx.beginPath();
  ctx.rect(clipX, 0, clipW, canvas.height);
  ctx.clip();
  const [lvl, nLevels] = levelForScale(scale);
  const ds = Math.pow(2, nLevels - 1 - lvl);
  const tileWorld = TILE * ds;
  const x0 = Math.max(0, Math.floor(((clipX - paneOx) / scale) / tileWorld));
  const y0 = Math.max(0, Math.floor((-oy / scale) / tileWorld));
  const x1 = Math.ceil(((clipX + clipW - paneOx) / scale) / tileWorld);
  const y1 = Math.ceil(((canvas.height - oy) / scale) / tileWorld);
  for (let li = 0; li < paneLayers.length; li++) {{
    const name = paneLayers[li];
    if (!session && !visible[name]) continue;
    ctx.globalAlpha = li === 0 ? 1.0 : alpha;
    for (let ty = y0; ty <= y1; ty++) {{
      for (let tx = x0; tx <= x1; tx++) {{
        const img = getTile(name, lvl, tx, ty, session);
        if (img.complete && img.naturalWidth > 0) {{
          ctx.drawImage(img, paneOx + tx * tileWorld * scale,
                        oy + ty * tileWorld * scale,
                        tileWorld * scale, tileWorld * scale);
        }}
      }}
    }}
  }}
  ctx.globalAlpha = 1.0;
  ctx.restore();
}}

function draw() {{
  if (!meta) return;
  ctx.fillStyle = '#111';
  ctx.fillRect(0, 0, canvas.width, canvas.height);
  if (auxSession) {{
    const half = canvas.width / 2;
    drawPane(0, half - 1, layers, null, ox);
    // right pane: linked pan/zoom, same world transform shifted by half
    drawPane(half + 1, half - 1, ['slide'], auxSession, ox + half);
    ctx.fillStyle = '#555';
    ctx.fillRect(half - 1, 0, 2, canvas.height);
  }} else {{
    drawPane(0, canvas.width, layers, null, ox);
  }}
}}

let dragging = false, lastX = 0, lastY = 0, moved = false;
// interaction modes: 'pan' | 'segbox' | 'sam'
let mode = 'pan';
let boxStart = null, boxEnd = null;
let samPoints = [];
view.onmousedown = e => {{
  if (mode === 'segbox') {{
    boxStart = [e.clientX, e.clientY - 48]; boxEnd = null; return;
  }}
  dragging = true; moved = false;
  lastX = e.clientX; lastY = e.clientY;
}};
function toWorld(sx, sy) {{
  return [(sx - ox) / scale, (sy - oy) / scale];
}}
window.onmouseup = async e => {{
  if (mode === 'segbox' && boxStart) {{
    boxEnd = [e.clientX, e.clientY - 48];
    const [wx0, wy0] = toWorld(boxStart[0], boxStart[1]);
    const [wx1, wy1] = toWorld(boxEnd[0], boxEnd[1]);
    boxStart = boxEnd = null; mode = 'pan';
    document.getElementById('info').textContent = 'segmenting box...';
    const res = await ctl('/tileserver/segment_on_box', 'PUT',
      {{x0: wx0, y0: wy0, x1: wx1, y1: wy1}});
    document.getElementById('info').textContent = res
      ? `segment: ${{res.count}} instances (types ${{res.types}})`
      : 'segment failed';
    await refreshLayers();
    return;
  }}
  if (mode === 'sam' && dragging && !moved) {{
    const [wx, wy] = toWorld(e.clientX, e.clientY - 48);
    samPoints.push([wx, wy]);
    document.getElementById('info').textContent =
      `SAM points: ${{samPoints.length}} (click "run SAM")`;
    dragging = false;
    drawOverlayMarks();
    return;
  }}
  if (dragging && !moved) {{
    const wx = (e.clientX - ox) / scale, wy = (e.clientY - 48 - oy) / scale;
    for (const name of layers.slice(1)) {{
      const r = await fetch(`/tileserver/tap_query/${{name}}/${{wx}}/${{wy}}`);
      if (r.ok) {{
        const hits = (await r.json()).annotations;
        document.getElementById('info').textContent =
          hits.length ? JSON.stringify(hits, null, 1) : '';
      }}
    }}
  }}
  dragging = false;
}};
function drawOverlayMarks() {{
  draw();
  ctx.fillStyle = '#f55';
  for (const [wx, wy] of samPoints) {{
    ctx.beginPath();
    ctx.arc(wx * scale + ox, wy * scale + oy, 4, 0, 7);
    ctx.fill();
  }}
}}
window.onmousemove = e => {{
  document.getElementById('pos').textContent =
    `(${{Math.round((e.clientX - ox)/scale)}}, ` +
    `${{Math.round((e.clientY - 48 - oy)/scale)}})`;
  if (!dragging) return;
  moved = true;
  ox += e.clientX - lastX; oy += e.clientY - lastY;
  lastX = e.clientX; lastY = e.clientY;
  draw();
}};
view.onwheel = e => {{
  e.preventDefault();
  const f = Math.pow(1.0015, -e.deltaY);
  const mx = e.clientX, my = e.clientY - 48;
  ox = mx - (mx - ox) * f;
  oy = my - (my - oy) * f;
  scale *= f;
  draw();
}};
document.getElementById('alpha').oninput = e => {{
  alpha = parseFloat(e.target.value); draw();
}};
window.onresize = () => {{ resize(); draw(); }};

async function ctl(path, method, params) {{
  const body = new URLSearchParams(params || {{}});
  const r = await fetch(path, {{method: method || 'PUT', body: body}});
  return r.ok ? r.json() : null;
}}

async function refreshLayers() {{
  const resp = await fetch('/tileserver/layers');
  const current = (await resp.json()).layers;
  for (const name of current) if (!(name in visible)) {{
    visible[name] = true;
    layers.push(name);
  }}
  tileCache.clear();
  draw();
}}

document.getElementById('ovload').onclick = async () => {{
  const path = document.getElementById('ovpath').value;
  if (!path) return;
  await ctl('/tileserver/overlay', 'PUT', {{overlay_path: path}});
  const props = await ctl('/tileserver/prop_names/all', 'GET');
  propNames = props ? props.prop_names : [];
  const sel = document.getElementById('colorprop');
  sel.innerHTML = '<option value="">type</option>';
  const statSel = document.getElementById('statprop');
  statSel.innerHTML = '';
  for (const p of propNames) {{
    const o = document.createElement('option');
    o.value = p; o.textContent = p; sel.appendChild(o);
    statSel.appendChild(o.cloneNode(true));
  }}
  await refreshLayers();
}};

document.getElementById('colorprop').onchange = async e => {{
  await ctl('/tileserver/color_prop', 'PUT', {{prop: e.target.value}});
  tileCache.clear();
  draw();
}};

// ---- predicate filter builder -------------------------------------------
let propNames = [];

function addFilterRow() {{
  const row = document.createElement('div');
  row.className = 'frow';
  const propSel = document.createElement('select');
  for (const p of propNames) {{
    const o = document.createElement('option');
    o.value = p; o.textContent = p; propSel.appendChild(o);
  }}
  const opSel = document.createElement('select');
  for (const op of ['==', '!=', '>', '>=', '<', '<=', 'contains']) {{
    const o = document.createElement('option');
    o.value = op; o.textContent = op; opSel.appendChild(o);
  }}
  const val = document.createElement('input');
  val.size = 10; val.placeholder = 'value';
  const del = document.createElement('button');
  del.textContent = 'x';
  del.onclick = () => {{ row.remove(); previewFilter(); }};
  row.append(propSel, opSel, val, del);
  [propSel, opSel, val].forEach(el => el.onchange = previewFilter);
  document.getElementById('filterrows').appendChild(row);
}}

function buildPredicate() {{
  const terms = [];
  for (const row of document.querySelectorAll('#filterrows .frow')) {{
    const [propSel, opSel, val] = row.querySelectorAll('select, input');
    if (!val.value) continue;
    const raw = val.value;
    const lit = isNaN(Number(raw)) ? JSON.stringify(raw) : raw;
    const prop = `props[${{JSON.stringify(propSel.value)}}]`;
    terms.push(opSel.value === 'contains'
      ? `contains(${{prop}}, ${{lit}})`
      : `(${{prop}} ${{opSel.value}} ${{lit}})`);
  }}
  return terms.join(' & ');
}}

function previewFilter() {{
  document.getElementById('filterpreview').textContent = buildPredicate();
}}

document.getElementById('filterbtn').onclick = () => {{
  const panel = document.getElementById('filterpanel');
  panel.style.display = panel.style.display === 'none' ? 'block' : 'none';
}};
document.getElementById('addrow').onclick = addFilterRow;
document.getElementById('applyfilter').onclick = async () => {{
  const pred = buildPredicate();
  await ctl('/tileserver/renderer/where', 'PUT', {{val: pred || 'null'}});
  tileCache.clear(); draw();
}};
document.getElementById('clearfilter').onclick = async () => {{
  document.getElementById('filterrows').innerHTML = '';
  previewFilter();
  await ctl('/tileserver/renderer/where', 'PUT', {{val: 'null'}});
  tileCache.clear(); draw();
}};

// ---- colormap + stats ----------------------------------------------------
document.getElementById('cmap').onchange = async e => {{
  await ctl('/tileserver/cmap', 'PUT', {{cmap: e.target.value}});
  tileCache.clear(); draw();
}};

async function showStats() {{
  const prop = document.getElementById('statprop').value;
  if (!prop) return;
  const data = await ctl(`/tileserver/prop_stats/${{prop}}`, 'GET');
  const stats = data && data.stats;
  const hc = document.getElementById('histcanvas');
  const hctx = hc.getContext('2d');
  hctx.clearRect(0, 0, hc.width, hc.height);
  if (!stats) {{ document.getElementById('statsummary').textContent = 'n/a'; return; }}
  if (stats.kind === 'numeric') {{
    document.getElementById('statsummary').textContent =
      `n=${{stats.count}} min=${{stats.min.toFixed(3)}} ` +
      `mean=${{stats.mean.toFixed(3)}} max=${{stats.max.toFixed(3)}}`;
    const peak = Math.max(...stats.hist, 1);
    const bw = hc.width / stats.hist.length;
    hctx.fillStyle = '#6c6';
    stats.hist.forEach((v, i) => {{
      const bh = (v / peak) * (hc.height - 4);
      hctx.fillRect(i * bw + 1, hc.height - bh, bw - 2, bh);
    }});
  }} else {{
    const entries = Object.entries(stats.value_counts);
    document.getElementById('statsummary').textContent =
      `n=${{stats.count}}, ${{entries.length}} distinct`;
    const peak = Math.max(...entries.map(e => e[1]), 1);
    const bw = hc.width / entries.length;
    hctx.fillStyle = '#69c';
    entries.forEach(([k, v], i) => {{
      const bh = (v / peak) * (hc.height - 14);
      hctx.fillRect(i * bw + 1, hc.height - bh - 12, bw - 2, bh);
      hctx.fillStyle = '#ddd'; hctx.font = '9px sans-serif';
      hctx.fillText(k.slice(0, 8), i * bw + 2, hc.height - 2);
      hctx.fillStyle = '#69c';
    }});
  }}
}}

document.getElementById('statsbtn').onclick = () => {{
  const panel = document.getElementById('statspanel');
  panel.style.display = panel.style.display === 'none' ? 'block' : 'none';
  if (panel.style.display === 'block') showStats();
}};
document.getElementById('statprop').onchange = showStats;

// ---- interactive model runs ---------------------------------------------
document.getElementById('segbox').onclick = () => {{
  mode = mode === 'segbox' ? 'pan' : 'segbox';
  document.getElementById('info').textContent =
    mode === 'segbox' ? 'drag a box to segment' : '';
}};
document.getElementById('sammode').onclick = () => {{
  mode = mode === 'sam' ? 'pan' : 'sam';
  samPoints = [];
  document.getElementById('samrun').style.display =
    mode === 'sam' ? 'inline' : 'none';
  document.getElementById('info').textContent =
    mode === 'sam' ? 'click to add prompt points' : '';
}};
document.getElementById('samrun').onclick = async () => {{
  if (!samPoints.length) return;
  document.getElementById('info').textContent = 'running SAM...';
  const res = await ctl('/tileserver/prompt_segment', 'PUT',
                        {{points: JSON.stringify(samPoints)}});
  document.getElementById('info').textContent = res
    ? `prompt: ${{res.count}} annotations` : 'SAM unavailable';
  samPoints = []; mode = 'pan';
  document.getElementById('samrun').style.display = 'none';
  await refreshLayers();
}};
document.getElementById('graphload').onclick = async () => {{
  const path = document.getElementById('graphpath').value;
  if (!path) return;
  const res = await ctl('/tileserver/graph', 'PUT', {{graph_path: path}});
  if (res) {{
    document.getElementById('info').textContent =
      `graph: ${{res.nodes}} nodes, ${{res.edges}} edges`;
    const sel = document.getElementById('colorprop');
    for (const p of res.node_props) {{
      const o = document.createElement('option');
      o.value = p; o.textContent = 'node ' + p; sel.appendChild(o);
    }}
  }}
  await refreshLayers();
}};

// ---- multichannel (fluorescence) controls ---------------------------------
let chanState = null;

function rgbToHex(c) {{
  return '#' + c.map(v => Math.round(v * 255).toString(16)
                           .padStart(2, '0')).join('');
}}

function hexToRgb(h) {{
  return [1, 3, 5].map(i => parseInt(h.slice(i, i + 2), 16) / 255);
}}

async function initChannels() {{
  const res = await ctl('/tileserver/channels', 'GET');
  if (!res || !res.names) return;
  chanState = {{names: res.names, colors: res.colors,
               active: res.active || res.names.map((_, i) => i)}};
  document.getElementById('chanbtn').style.display = 'inline';
  renderChanRows();
}}

function renderChanRows() {{
  const div = document.getElementById('chanrows');
  div.innerHTML = '';
  chanState.names.forEach((name, i) => {{
    const lbl = document.createElement('label');
    lbl.className = 'chanrow';
    const cb = document.createElement('input');
    cb.type = 'checkbox';
    cb.checked = chanState.active.includes(i);
    const pick = document.createElement('input');
    pick.type = 'color';
    pick.value = rgbToHex(chanState.colors[i]);
    lbl.append(cb, pick, document.createTextNode(name));
    div.appendChild(lbl);
  }});
}}

async function applyChannels() {{
  const rows = document.querySelectorAll('#chanrows .chanrow');
  const dict = {{}};
  const active = [];
  rows.forEach((row, i) => {{
    const [cb, pick] = row.querySelectorAll('input');
    dict[chanState.names[i]] = hexToRgb(pick.value);
    if (cb.checked) active.push(i);
  }});
  const res = await ctl('/tileserver/channels', 'PUT',
    {{channels: JSON.stringify(dict), active: JSON.stringify(active)}});
  if (res) chanState = {{names: res.names, colors: res.colors,
                        active: res.active}};
  tileCache.clear();
  draw();
}}

document.getElementById('chanbtn').onclick = () => {{
  const panel = document.getElementById('chanpanel');
  panel.style.display = panel.style.display === 'none' ? 'block' : 'none';
}};
document.getElementById('chanapply').onclick = applyChannels;
document.getElementById('chanall').onclick = () => {{
  document.querySelectorAll('#chanrows input[type=checkbox]')
    .forEach(cb => cb.checked = true);
  applyChannels();
}};
document.getElementById('channone').onclick = () => {{
  document.querySelectorAll('#chanrows input[type=checkbox]')
    .forEach(cb => cb.checked = false);
  applyChannels();
}};
document.getElementById('enhance').oninput = async e => {{
  const v = parseFloat(e.target.value);
  document.getElementById('enhanceval').textContent = v.toFixed(1);
  await ctl('/tileserver/enhance', 'PUT', {{val: v}});
  tileCache.clear();
  draw();
}};

document.getElementById('split').onclick = async () => {{
  const path = document.getElementById('slide2').value;
  if (auxSession || !path) {{ auxSession = null; draw(); return; }}
  const sess = await ctl('/tileserver/session_id', 'PUT');
  if (!sess) return;
  const ok = await ctl('/tileserver/slide', 'PUT',
                       {{session_id: sess.session_id, slide_path: path}});
  if (ok) {{ auxSession = sess.session_id; tileCache.clear(); draw(); }}
}};
init();
</script>
</body>
</html>
"""


def render_viewer_html(title: str = "tiatoolbox-tpu-torch viewer") -> str:
    """The viewer page HTML (layers discovered client-side)."""
    return VIEWER_HTML.format(title=title)
